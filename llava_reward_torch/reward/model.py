"""The reward model: backbone forward + SkipCA + value head read-out
(``llava_reward_tpu/reward/model.py``), phi3v, Qwen2.5-VL and LLaVA-NeXT
branches.

The pair (chosen, rejected) is scored by stacking along the batch axis in
one forward. phi3v's uint8 pixels are prepared on the batch's device
(``ops/pixels.py``). SkipCA is not wired for LLaVA, as in the reference
(rw_model_general_preference.py:372-375).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.distributed as dist

from ..core.config import LlavaNextConfig, Phi3VConfig, Qwen25VLConfig, RewardConfig
from ..core.device import DEFAULT_DEVICE, resolve_device
from ..models import llava_next, phi3v, qwen25_vl
from ..ops.pixels import hd_resize_u8_bank, prepare_pixel_bank
from ..parallel.collectives import all_reduce
from . import heads, skipca


def _is_qwen(cfg) -> bool:
    return isinstance(cfg, Qwen25VLConfig)


def _is_llava(cfg) -> bool:
    return isinstance(cfg, LlavaNextConfig)


def hidden_size_of(cfg) -> int:
    return cfg.text.hidden_size if hasattr(cfg, "text") else cfg.decoder.hidden_size


def num_layers_of(cfg) -> int:
    return cfg.text.num_layers if hasattr(cfg, "text") else cfg.decoder.num_layers


def rms_eps_of(cfg) -> float:
    return cfg.text.rms_norm_eps if hasattr(cfg, "text") else cfg.decoder.rms_norm_eps


class RewardBatch(NamedTuple):
    """Static-shape batch, the JAX package's ``RewardBatch``. Qwen2.5-VL puts
    its windowed patch array in ``pixel_values`` (f32 / bf16, or uint8
    normalised on the device) and adds the qwen fields. phi3v's uint8 forms:
    crops only (B, nc, 336, 336, 3) with ``crop_grid``, or the decoded
    original (B, Hs, Ws, 3) with ``crop_grid`` and ``resize_tabs``."""

    input_ids: torch.Tensor  # (B, S)
    attention_mask: torch.Tensor  # (B, S)
    pixel_values: Optional[torch.Tensor]  # phi3v: (B, crops+1, 336, 336, 3); qwen: (B, P, patch_dim)
    img_gather_idx: Optional[torch.Tensor]  # (B, T_img) phi3v feature-bank gather
    splice_idx: Optional[torch.Tensor]  # (B, S)
    num_img_tokens: Optional[torch.Tensor]  # (B,)
    position_ids: Optional[torch.Tensor] = None  # qwen M-RoPE (3, B, S)
    patch_valid: Optional[torch.Tensor] = None  # qwen (B, P) segment ids, 0 = pad
    rot_pos: Optional[torch.Tensor] = None  # qwen (B, P, 2)
    unit_gather: Optional[torch.Tensor] = None  # qwen (B, U)
    crop_grid: Optional[torch.Tensor] = None  # phi3v u8 path: (B, 2) (hc, wc)
    resize_tabs: Optional[dict] = None  # phi3v device-resize path: bilinear tap tables


class RewardOutput(NamedTuple):
    reward: torch.Tensor  # (B, value_head_dim)
    prompt_hidden: Optional[torch.Tensor]
    last_hidden: Optional[torch.Tensor]  # raw backbone last_hidden_state


def init_head_params(
    cfg,
    rcfg: RewardConfig,
    generator: torch.Generator,
    dtype: torch.dtype = torch.float32,
    device=DEFAULT_DEVICE,
) -> dict:
    """Value head, optional SkipCA and the optional MoE prompt head
    (``model.py:83-96``)."""
    dev = resolve_device(device)
    H = hidden_size_of(cfg)
    dim = rcfg.value_head_dim if rcfg.is_general_preference else 1
    p = {"value_head": heads.init_value_head(H, dim, generator, dtype, dev)}
    if rcfg.add_cross_attention:
        p["skipca"] = skipca.init_params(H, generator, dtype, dev)
    if rcfg.is_general_preference and rcfg.add_prompt_head:
        p["prompt_head"] = heads.init_prompt_head(H, rcfg.value_head_dim, generator, dtype, dev)
    return p


def _global_max(t: torch.Tensor, group) -> torch.Tensor:
    return all_reduce(t, group, op=dist.ReduceOp.MAX)


def _check_family(cfg) -> None:
    if not isinstance(cfg, (Phi3VConfig, Qwen25VLConfig, LlavaNextConfig)):
        raise NotImplementedError(
            f"{type(cfg).__name__}: the families are Phi-3.5-vision, Qwen2.5-VL and "
            "LLaVA-NeXT"
        )


def reward_forward(
    params: dict,  # {'backbone': phi3v / qwen tree, 'head': head tree}
    cfg,
    rcfg: RewardConfig,
    batch: RewardBatch,
    *,
    training: bool = False,
    attn_impl: str = "auto",
    remat: bool = False,
    lora: Optional[dict] = None,
    vision_lora: Optional[dict] = None,
    prompt_end_index: Optional[torch.Tensor] = None,
    skipca_batch_max: Optional[torch.Tensor] = None,
    data_group=None,
    tp=None,
) -> RewardOutput:
    """``data_group``: the process group of the data ranks when this batch
    is one rank's share of a global batch. phi3v's SkipCA then zero-pads to
    the global batch's largest image-token count, as the JAX package's
    forward over the whole batch does. ``tp``
    (``parallel/tensor.TensorParallel``): the backbone's towers and decoder
    run split over the tp axis; ``params`` holds the stacked layers' blocks
    (``parallel/sharding.shard_params``) and every other leaf whole
    (``gather_unstacked``), so SkipCA and the heads run whole on every
    rank."""
    _check_family(cfg)
    attention_mask = batch.attention_mask
    collect = None if rcfg.layer_id >= num_layers_of(cfg) else rcfg.layer_id

    if _is_qwen(cfg):
        if batch.position_ids is None:
            raise ValueError("qwen needs M-RoPE position_ids")
        if vision_lora is not None:
            raise NotImplementedError("vision LoRA is phi3v's (--train_vision)")
        out = qwen25_vl.forward(
            params["backbone"], cfg, batch.input_ids, attention_mask, batch.position_ids,
            batch.pixel_values, batch.patch_valid, batch.rot_pos, batch.unit_gather,
            batch.splice_idx, batch.num_img_tokens, collect_layer_id=collect,
            attn_impl=attn_impl, remat=remat, lora=lora, tp=tp,
        )
        skipca_mode = "qwen"  # per-sample -1e4 mask
    elif _is_llava(cfg):
        if vision_lora is not None:
            raise NotImplementedError("vision LoRA is phi3v's (--train_vision)")
        out = llava_next.forward(
            params["backbone"], cfg, batch.input_ids, attention_mask, batch.pixel_values,
            batch.img_gather_idx, batch.splice_idx, batch.num_img_tokens,
            collect_layer_id=collect, attn_impl=attn_impl, remat=remat, lora=lora, tp=tp,
        )
        skipca_mode = None  # SkipCA is not wired for llava (rw:372-375)
    else:
        # position_ids = cumsum(mask)-1 with pads forced to 1 (model.py:154-156)
        position_ids = torch.cumsum(attention_mask.to(torch.int32), dim=-1) - 1
        position_ids = torch.where(attention_mask == 0, torch.ones_like(position_ids),
                                   position_ids)
        pixel_values = batch.pixel_values
        if pixel_values is not None and pixel_values.dtype == torch.uint8:
            # device-side preparation (``model.py:158-176``): u8 crops -> the
            # normalised bank with the global view; from the decoded original,
            # the PIL-exact HD resize, white padding and crop split first
            if batch.crop_grid is None:
                raise ValueError("uint8 phi3v pixels need crop_grid")
            if batch.resize_tabs is not None:
                t = batch.resize_tabs
                pixel_values = hd_resize_u8_bank(
                    pixel_values, t["hidx"], t["hw"], t["vidx"], t["vw"], t["vbias"],
                    t["col_start"], t["slot_perm"], t["tflag"])
            pixel_values = prepare_pixel_bank(pixel_values, batch.crop_grid,
                                              dtype=torch.float32)
        out = phi3v.forward(
            params["backbone"], cfg, batch.input_ids, attention_mask, position_ids,
            pixel_values, batch.img_gather_idx, batch.splice_idx, batch.num_img_tokens,
            collect_layer_id=collect, attn_impl=attn_impl, remat=remat, lora=lora,
            vision_lora=vision_lora, tp=tp,
        )
        skipca_mode = "phi3v"

    hidden = out.last_hidden_state if collect is None else out.collected_hidden_state
    if rcfg.add_cross_attention and skipca_mode and out.vision_embedding is not None:
        vision = out.vision_embedding
        if skipca_mode == "phi3v" and data_group is not None:
            if skipca_batch_max is None:
                skipca_batch_max = _global_max(batch.num_img_tokens.max()[None], data_group)[0]
            width = int(torch.max(skipca_batch_max))  # this rank's batch may hold fewer slots
            vision = torch.nn.functional.pad(vision, (0, 0, 0, max(width - vision.shape[1], 0)))
        hidden = skipca.apply(
            params["head"]["skipca"], hidden, vision, batch.num_img_tokens,
            rms_eps=rms_eps_of(cfg), mode=skipca_mode, batch_max=skipca_batch_max,
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
    cfg,
    rcfg: RewardConfig,
    chosen: RewardBatch,
    rejected: RewardBatch,
    *,
    training: bool = True,
    attn_impl: str = "auto",
    remat: bool = False,
    lora: Optional[dict] = None,
    vision_lora: Optional[dict] = None,
    prompt_end_index: Optional[torch.Tensor] = None,
    data_group=None,
    tp=None,
):
    """Score (chosen, rejected) in one stacked forward (``model.py:235-303``).
    Qwen's M-RoPE ``position_ids`` (3, B, S) stack on axis 1. phi3v: each
    half's SkipCA zero-pad width is that half's own max image-token count,
    as in the reference's two separate forwards (qwen masks per sample);
    over all data ranks under ``data_group`` (``reward_forward``)."""
    _check_family(cfg)

    def cat(name, a, b):
        if a is None:
            return None
        if isinstance(a, dict):  # resize_tabs
            return {k: torch.cat([a[k], b[k]]) for k in a}
        return torch.cat([a, b], dim=1 if name == "position_ids" else 0)

    stacked = RewardBatch(*[cat(n, a, b) for n, a, b in
                            zip(RewardBatch._fields, chosen, rejected)])
    skipca_bm = None
    if (rcfg.add_cross_attention and not _is_qwen(cfg)
            and chosen.num_img_tokens is not None):
        Bc = chosen.input_ids.shape[0]
        m = torch.stack([torch.max(chosen.num_img_tokens), torch.max(rejected.num_img_tokens)])
        if data_group is not None:
            m = _global_max(m, data_group)
        skipca_bm = torch.cat([m[0].expand(Bc), m[1].expand(Bc)])
    out = reward_forward(
        params, cfg, rcfg, stacked, training=training, attn_impl=attn_impl, remat=remat,
        lora=lora, vision_lora=vision_lora, prompt_end_index=cat(
            "prompt_end_index", prompt_end_index, prompt_end_index),
        skipca_batch_max=skipca_bm, data_group=data_group, tp=tp,
    )
    B = chosen.input_ids.shape[0]
    prompt_hidden = out.prompt_hidden[:B] if out.prompt_hidden is not None else None
    return out.reward[:B], out.reward[B:], prompt_hidden, out.last_hidden[:B]

