"""The system under test: the port's config for the family, its reward
adaptor over the seeded weights (the tail of ``load_reward_adaptor``: the
scoring merge, the optional quantization of the decoder, the cast to the
served dtype), its processor and its tokenizer set-up. Everything here calls
the port."""

from __future__ import annotations

import torch

from . import family


def reward_config(cfg: dict):
    from llava_reward_torch.core.config import RewardConfig

    r = cfg["reward"]
    layers = cfg["text"]["num_hidden_layers"]
    return RewardConfig(is_general_preference=r["is_general_preference"],
                        add_cross_attention=r["add_cross_attention"],
                        value_head_dim=r["value_head_dim"],
                        general_preference_tau=r["general_preference_tau"], layer_id=layers)


def adaptor(cfg: dict, weights: dict, quantize=None, device="cuda", dtype=torch.bfloat16,
            min_size: int = 1 << 20):
    """``load_reward_adaptor``'s tail over trees already in memory: the
    scoring merge (qwen's projections fused), the decoder quantized by the
    scheme ``quantize`` names ('w8a8', 'int4', 'nf4'), every float leaf cast
    to ``dtype``. ``weights`` is consumed."""
    from llava_reward_torch.evalx.adaptor import RewardAdaptor, cast_params, merge_for_scoring
    from llava_reward_torch.utils.quantize import quantize_stacked_layers

    fam = family.of(cfg)
    backbone = merge_for_scoring(weights.pop("backbone"), cfg["family"])
    if quantize:
        scheme = {"w8a8": "w8a8", "nf4": "nf4"}.get(quantize, "absmax")
        bits = 4 if quantize in ("nf4", "int4") else 8
        dec = fam.DECODER
        backbone[dec] = {**backbone[dec], "layers": quantize_stacked_layers(
            backbone[dec]["layers"], bits=bits, scheme=scheme, min_size=min_size)}
    params = cast_params({"backbone": backbone, "head": weights.pop("head")}, dtype)
    return RewardAdaptor(cfg=fam.port_config(cfg), rcfg=reward_config(cfg), params=params,
                         model_type=cfg["family"], device=device)


def processor(cfg: dict, tokenizer, pcfg):
    """The registry's processor (u8 pixels prepared on the device) and the
    family's tokenizer set-up."""
    from llava_reward_torch.core.registry import get_family

    fam = get_family(cfg["family"])
    fam.tokenizer_setup(tokenizer)
    return fam.make_processor(tokenizer, pcfg)
