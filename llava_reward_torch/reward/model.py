"""The reward model: backbone forward + SkipCA + value head read-out
(``llava_reward_tpu/reward/model.py``), phi3v branch.

The pair (chosen, rejected) is scored by stacking along the batch axis in
one forward. The Qwen2.5-VL and LLaVA-NeXT branches, and the u8 device-pixel
path, wait for their ROADMAP slices.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..core.config import Phi3VConfig, RewardConfig
from ..core.device import DEFAULT_DEVICE, resolve_device
from ..models import phi3v
from . import heads, skipca


class RewardBatch(NamedTuple):
    """Static-shape phi3v batch (the first six fields of the JAX package's
    ``RewardBatch``; the Qwen and device-pixel fields come with slices 5
    and 3)."""

    input_ids: torch.Tensor  # (B, S)
    attention_mask: torch.Tensor  # (B, S)
    pixel_values: Optional[torch.Tensor]  # (B, crops+1, 336, 336, 3)
    img_gather_idx: Optional[torch.Tensor]  # (B, T_img)
    splice_idx: Optional[torch.Tensor]  # (B, S)
    num_img_tokens: Optional[torch.Tensor]  # (B,)


class RewardOutput(NamedTuple):
    reward: torch.Tensor  # (B, value_head_dim)
    prompt_hidden: Optional[torch.Tensor]
    last_hidden: Optional[torch.Tensor]  # raw backbone last_hidden_state


def init_head_params(
    cfg: Phi3VConfig,
    rcfg: RewardConfig,
    generator: torch.Generator,
    dtype: torch.dtype = torch.float32,
    device=DEFAULT_DEVICE,
) -> dict:
    """Value head and optional SkipCA (``model.py:83-96``). The MoE prompt
    head belongs to training (ROADMAP slice 4)."""
    dev = resolve_device(device)
    H = cfg.decoder.hidden_size
    dim = rcfg.value_head_dim if rcfg.is_general_preference else 1
    p = {"value_head": heads.init_value_head(H, dim, generator, dtype, dev)}
    if rcfg.add_cross_attention:
        p["skipca"] = skipca.init_params(H, generator, dtype, dev)
    if rcfg.is_general_preference and rcfg.add_prompt_head:
        raise NotImplementedError("the MoE prompt head is ROADMAP slice 4 (training)")
    return p


def _check_phi3v(cfg) -> None:
    if not isinstance(cfg, Phi3VConfig):
        raise NotImplementedError(
            f"{type(cfg).__name__}: only Phi-3.5-vision is ported; Qwen2.5-VL is "
            "ROADMAP slice 5 and LLaVA-NeXT slice 6"
        )


def reward_forward(
    params: dict,  # {'backbone': phi3v tree, 'head': head tree}
    cfg: Phi3VConfig,
    rcfg: RewardConfig,
    batch: RewardBatch,
    *,
    training: bool = False,
    attn_impl: str = "auto",
    lora: Optional[dict] = None,
    prompt_end_index: Optional[torch.Tensor] = None,
    skipca_batch_max: Optional[torch.Tensor] = None,
) -> RewardOutput:
    _check_phi3v(cfg)
    attention_mask = batch.attention_mask
    collect = None if rcfg.layer_id >= cfg.decoder.num_layers else rcfg.layer_id

    # position_ids = cumsum(mask)-1 with pads forced to 1 (model.py:154-156)
    position_ids = torch.cumsum(attention_mask.to(torch.int32), dim=-1) - 1
    position_ids = torch.where(attention_mask == 0, torch.ones_like(position_ids), position_ids)
    pixel_values = batch.pixel_values
    if pixel_values is not None and pixel_values.dtype == torch.uint8:
        raise NotImplementedError(
            "u8 device-side pixel preparation (ops/pixels.py) is ROADMAP slice 3"
        )
    out = phi3v.forward(
        params["backbone"], cfg, batch.input_ids, attention_mask, position_ids,
        pixel_values, batch.img_gather_idx, batch.splice_idx, batch.num_img_tokens,
        collect_layer_id=collect, attn_impl=attn_impl, lora=lora,
    )

    hidden = out.last_hidden_state if collect is None else out.collected_hidden_state
    if rcfg.add_cross_attention and out.vision_embedding is not None:
        hidden = skipca.apply(
            params["head"]["skipca"], hidden, out.vision_embedding, batch.num_img_tokens,
            rms_eps=cfg.decoder.rms_norm_eps, mode="phi3v", batch_max=skipca_batch_max,
        )

    if rcfg.mean_hidden_state:
        pooled = heads.masked_mean_pool(hidden, attention_mask)
        reward = heads.apply_value_head(params["head"]["value_head"], pooled)
    else:
        values = heads.apply_value_head(params["head"]["value_head"], hidden)
        reward = heads.readout(values, attention_mask, training=training, mean_pooled=False)

    prompt_hidden = None
    if prompt_end_index is not None:
        lh = out.last_hidden_state
        prompt_hidden = lh[torch.arange(lh.shape[0], device=lh.device), prompt_end_index]
    return RewardOutput(reward=reward, prompt_hidden=prompt_hidden,
                        last_hidden=out.last_hidden_state)


def paired_forward(
    params: dict,
    cfg: Phi3VConfig,
    rcfg: RewardConfig,
    chosen: RewardBatch,
    rejected: RewardBatch,
    *,
    training: bool = True,
    attn_impl: str = "auto",
    lora: Optional[dict] = None,
    prompt_end_index: Optional[torch.Tensor] = None,
):
    """Score (chosen, rejected) in one stacked forward (``model.py:235-303``).
    Each half's SkipCA zero-pad width is that half's own max image-token
    count, as in the reference's two separate forwards."""
    _check_phi3v(cfg)

    def cat(a, b):
        return None if a is None else torch.cat([a, b], dim=0)

    stacked = RewardBatch(*[cat(a, b) for a, b in zip(chosen, rejected)])
    skipca_bm = None
    if rcfg.add_cross_attention and chosen.num_img_tokens is not None:
        Bc = chosen.input_ids.shape[0]
        skipca_bm = torch.cat([
            torch.max(chosen.num_img_tokens).expand(Bc),
            torch.max(rejected.num_img_tokens).expand(Bc),
        ])
    out = reward_forward(
        params, cfg, rcfg, stacked, training=training, attn_impl=attn_impl, lora=lora,
        prompt_end_index=(
            cat(prompt_end_index, prompt_end_index) if prompt_end_index is not None else None
        ),
        skipca_batch_max=skipca_bm,
    )
    B = chosen.input_ids.shape[0]
    prompt_hidden = out.prompt_hidden[:B] if out.prompt_hidden is not None else None
    return out.reward[:B], out.reward[B:], prompt_hidden, out.last_hidden[:B]

