"""HF Qwen2.5-VL checkpoint <-> the param tree (the port's own copy of
``llava_reward_tpu/io/hf_qwen.py``, and its inverse).

Key layout (HF Qwen2_5_VLForConditionalGeneration; both the 4.50-era
('visual.', 'model.') and newer ('model.visual.', 'model.language_model.')
prefixes are accepted):

  visual.patch_embed.proj.weight  (H, C, tps, ps, ps) -> (patch_dim, H)
  visual.blocks.{i}.{norm1,norm2}.weight
  visual.blocks.{i}.attn.qkv.{weight,bias}   (fused 3H)
  visual.blocks.{i}.attn.proj.{weight,bias}
  visual.blocks.{i}.mlp.{gate_proj,up_proj,down_proj}.{weight,bias}
  visual.merger.ln_q.weight, visual.merger.mlp.{0,2}.{weight,bias}
  model.embed_tokens.weight
  model.layers.{i}.self_attn.{q,k,v}_proj.{weight,bias}, o_proj.weight
  model.layers.{i}.mlp.{gate,up,down}_proj.weight
  model.layers.{i}.{input,post_attention}_layernorm.weight
  model.norm.weight, lm_head.weight

The tree keeps q/k/v and gate/up separate (the training layout);
``models/qwen25_vl.fuse_decoder_projections`` makes the scoring layout.
"""

from __future__ import annotations

from typing import Dict

import torch

from ..core.config import Qwen25VLConfig
from .torch_io import REWARD_HEAD_PATTERNS, TrackedStateDict, check_fully_consumed


def _t(x: torch.Tensor) -> torch.Tensor:
    return x.T.contiguous()


def _normalise_keys(sd: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    out = {}
    for k, v in sd.items():
        k = k.replace("model.visual.", "visual.")
        k = k.replace("model.language_model.", "model.")
        k = k.replace("language_model.model.", "model.")
        out[k] = v
    return out


def params_from_hf_state_dict(
    sd: Dict[str, torch.Tensor], cfg: Qwen25VLConfig, dtype: torch.dtype = torch.float32,
    strict: bool = True, ignore_head_keys: bool = False,
) -> dict:
    """The qwen param tree (models/qwen25_vl.py layout) from an HF state
    dict, on the CPU in ``dtype``; strict as ``hf_phi3v``'s loader."""
    sd = TrackedStateDict(_normalise_keys(sd))
    vc, tc = cfg.vision, cfg.text

    def get(k):
        return sd[k].to(dtype)

    def vstack(fmt, transform=lambda x: x):
        return torch.stack([transform(get(fmt.format(i=i))) for i in range(vc.depth)])

    def tstack(fmt, transform=lambda x: x):
        return torch.stack([transform(get(fmt.format(i=i))) for i in range(tc.num_layers)])

    def vlinear(sub):
        return {"kernel": vstack(f"visual.blocks.{{i}}.{sub}.weight", _t),
                "bias": vstack(f"visual.blocks.{{i}}.{sub}.bias")}

    def tlinear(sub, bias):
        out = {"kernel": tstack(f"model.layers.{{i}}.{sub}.weight", _t)}
        if bias:
            out["bias"] = tstack(f"model.layers.{{i}}.{sub}.bias")
        return out

    patch = get("visual.patch_embed.proj.weight")  # (H, C, tps, ps, ps)
    visual = {
        "patch_embed": patch.reshape(patch.shape[0], -1).T.contiguous(),
        "blocks": {
            "norm1": vstack("visual.blocks.{i}.norm1.weight"),
            "norm2": vstack("visual.blocks.{i}.norm2.weight"),
            "qkv": vlinear("attn.qkv"),
            "proj": vlinear("attn.proj"),
            "mlp": {name: vlinear(f"mlp.{name}_proj") for name in ("gate", "up", "down")},
        },
        "merger": {
            "ln_q": get("visual.merger.ln_q.weight"),
            "fc1": {"kernel": _t(get("visual.merger.mlp.0.weight")),
                    "bias": get("visual.merger.mlp.0.bias")},
            "fc2": {"kernel": _t(get("visual.merger.mlp.2.weight")),
                    "bias": get("visual.merger.mlp.2.bias")},
        },
    }

    text = {
        "embed_tokens": get("model.embed_tokens.weight"),
        "layers": {
            "input_layernorm": tstack("model.layers.{i}.input_layernorm.weight"),
            **{f"{n}_proj": tlinear(f"self_attn.{n}_proj", True) for n in ("q", "k", "v")},
            "o_proj": tlinear("self_attn.o_proj", False),
            "post_attention_layernorm": tstack("model.layers.{i}.post_attention_layernorm.weight"),
            **{f"{n}_proj": tlinear(f"mlp.{n}_proj", False) for n in ("gate", "up", "down")},
        },
        "final_layernorm": get("model.norm.weight"),
    }

    tree = {"visual": visual, "text": text}
    if "lm_head.weight" in sd:
        tree["lm_head"] = _t(get("lm_head.weight"))
    check_fully_consumed(
        sd, strict=strict, what="qwen base checkpoint",
        ignore=REWARD_HEAD_PATTERNS if ignore_head_keys else (),
    )
    return tree


def hf_state_dict_from_params(params: dict, cfg: Qwen25VLConfig) -> Dict[str, torch.Tensor]:
    """The inverse mapping, 4.50-era key names, CPU tensors in the tree's
    dtype (the separate q/k/v, gate/up layout of ``params_from_hf_state_dict``)."""

    def h(x):  # a copy: a slice of a stacked leaf would save the whole stack
        return x.detach().to("cpu", copy=True)

    def ht(x):
        return h(x).T.contiguous()

    vc, tc = cfg.vision, cfg.text
    vis, txt = params["visual"], params["text"]
    sd: Dict[str, torch.Tensor] = {
        "visual.patch_embed.proj.weight": ht(vis["patch_embed"]).reshape(
            vc.hidden_size, vc.in_channels, vc.temporal_patch_size, vc.patch_size,
            vc.patch_size),
        "visual.merger.ln_q.weight": h(vis["merger"]["ln_q"]),
        "model.embed_tokens.weight": h(txt["embed_tokens"]),
        "model.norm.weight": h(txt["final_layernorm"]),
    }
    for i, fc in ((0, "fc1"), (2, "fc2")):
        sd[f"visual.merger.mlp.{i}.weight"] = ht(vis["merger"][fc]["kernel"])
        sd[f"visual.merger.mlp.{i}.bias"] = h(vis["merger"][fc]["bias"])
    b = vis["blocks"]
    for i in range(vc.depth):
        pre = f"visual.blocks.{i}"
        sd[f"{pre}.norm1.weight"] = h(b["norm1"][i])
        sd[f"{pre}.norm2.weight"] = h(b["norm2"][i])
        for sub, leaf in (("attn.qkv", b["qkv"]), ("attn.proj", b["proj"]),
                          *[(f"mlp.{n}_proj", b["mlp"][n]) for n in ("gate", "up", "down")]):
            sd[f"{pre}.{sub}.weight"] = ht(leaf["kernel"][i])
            sd[f"{pre}.{sub}.bias"] = h(leaf["bias"][i])
    lay = txt["layers"]
    for i in range(tc.num_layers):
        pre = f"model.layers.{i}"
        sd[f"{pre}.input_layernorm.weight"] = h(lay["input_layernorm"][i])
        sd[f"{pre}.post_attention_layernorm.weight"] = h(lay["post_attention_layernorm"][i])
        for n in ("q", "k", "v", "o"):
            sd[f"{pre}.self_attn.{n}_proj.weight"] = ht(lay[f"{n}_proj"]["kernel"][i])
            if "bias" in lay[f"{n}_proj"]:
                sd[f"{pre}.self_attn.{n}_proj.bias"] = h(lay[f"{n}_proj"]["bias"][i])
        for n in ("gate", "up", "down"):
            sd[f"{pre}.mlp.{n}_proj.weight"] = ht(lay[f"{n}_proj"]["kernel"][i])
    if "lm_head" in params:
        sd["lm_head.weight"] = ht(params["lm_head"])
    return sd
