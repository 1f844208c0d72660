"""Qwen2.5-VL backbone (``llava_reward_tpu/models/qwen25_vl.py``).

- Vision tower: the patch "conv3d" is one matmul; blocks stacked on a
  leading axis and run by a Python loop, each a full-attention block (its
  index in ``fullatt_block_indexes``) or a window block. Window attention is
  a reshape to (B*num_windows, win_patches) and batched attention over the
  host's window-ordered, padded layout (``preprocess/qwen_vision.windowize``);
  full blocks attend within one segment id (0 = pad). 2D rotary in fp32.
  On the card the full blocks (P >= 256) run B3's segment mode; the
  64-patch windows stay on the reference, as ``ops/attention.mha`` routes
  short bidirectional rows. uint8 patches are normalised on the device.
- Merger (RMSNorm -> 2x2-unit concat -> GELU MLP) in window order, then one
  gather restores the original merged-unit order, invalid units zeroed.
- Decoder: Qwen2 GQA with q/k/v bias, M-RoPE, SwiGLU. Two layouts: the
  separate q/k/v and gate/up projections (LoRA rides there), and the fused
  inference layout of ``fuse_decoder_projections`` (one qkv matmul feeding
  ``fused_rope_attention``: B2 x3 + B3 on the card; one gate_up matmul).
  W8A8 leaves run through the int8 GEMM; on the fused layout, with no LoRA
  and a 128-multiple width, the kernel route (on the card, or
  ``attn_impl="pallas"``) takes the activation codes from the quantizing
  epilogues: RMSNorm -> codes for qkv and gate_up (B4), silu(gate)*up ->
  codes for down (B5). o_proj stays on the dynamic form (B6 + the GEMM), as
  the JAX package leaves it (``qwen25_vl.py:399-403``).

Param tree:
  visual: {patch_embed (pd, H), blocks{norm1, norm2 (L, H),
           qkv{kernel (L, H, 3H), bias}, proj{kernel, bias},
           mlp{gate|up|down: {kernel, bias}}},
           merger{ln_q (H,), fc1{kernel (mm*H, mm*H), bias},
                  fc2{kernel (mm*H, out), bias}}}
  text:   {embed_tokens (V, H), layers{input_layernorm, q|k|v_proj{kernel,
           bias}, o_proj{kernel}, post_attention_layernorm,
           gate|up|down_proj{kernel}}, final_layernorm}
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from ..core.config import Qwen25VLConfig, QwenTextConfig, QwenVisionConfig
from ..core.device import DEFAULT_DEVICE, on_card, resolve_device
from ..ops import quant_epilogue as qe
from ..ops.activations import gelu, silu
from ..ops.attention import fused_rope_attention, mha
from ..ops.linear import mm
from ..ops.norms import rms_norm
from ..ops.rope import apply_rotary
from ..preprocess.qwen_vision import patch_norm_vectors
from ..parallel.tensor import column, enter, local_cols, local_heads, lora_of, row, row_silu_mul
from ..utils.quantize import cat_out, dequant_layer, int8_linear_pre, is_w8a8
from .clip_vit import stacked_layer
from .phi3v import _take_rows

# ------------------------------------------------------------------ init


def _dense_fn(generator, dtype, dev):
    def dense(*shape):
        return torch.randn(*shape, generator=generator, device=dev, dtype=dtype).mul_(0.02)

    return dense


def init_vision_params(
    vc: QwenVisionConfig,
    generator: torch.Generator,
    dtype: torch.dtype = torch.float32,
    device=DEFAULT_DEVICE,
) -> dict:
    """Random init (normal, std 0.02) drawn from ``generator`` on ``device``."""
    dev = resolve_device(device)
    dense = _dense_fn(generator, dtype, dev)
    H, I, L = vc.hidden_size, vc.intermediate_size, vc.depth
    mm2 = vc.spatial_merge_size ** 2

    def lin(i, o):
        return {"kernel": dense(L, i, o), "bias": torch.zeros(L, o, device=dev, dtype=dtype)}

    return {
        "patch_embed": dense(vc.patch_dim, H),
        "blocks": {
            "norm1": torch.ones(L, H, device=dev, dtype=dtype),
            "norm2": torch.ones(L, H, device=dev, dtype=dtype),
            "qkv": lin(H, 3 * H),
            "proj": lin(H, H),
            "mlp": {"gate": lin(H, I), "up": lin(H, I), "down": lin(I, H)},
        },
        "merger": {
            "ln_q": torch.ones(H, device=dev, dtype=dtype),
            "fc1": {"kernel": dense(mm2 * H, mm2 * H),
                    "bias": torch.zeros(mm2 * H, device=dev, dtype=dtype)},
            "fc2": {"kernel": dense(mm2 * H, vc.out_hidden_size),
                    "bias": torch.zeros(vc.out_hidden_size, device=dev, dtype=dtype)},
        },
    }


def init_text_params(
    tc: QwenTextConfig,
    generator: torch.Generator,
    dtype: torch.dtype = torch.float32,
    device=DEFAULT_DEVICE,
) -> dict:
    """Random init (normal, std 0.02) drawn from ``generator`` on ``device``."""
    dev = resolve_device(device)
    dense = _dense_fn(generator, dtype, dev)
    H, I, L, V = tc.hidden_size, tc.intermediate_size, tc.num_layers, tc.vocab_size

    def lin(i, o, bias=True):
        d = {"kernel": dense(L, i, o)}
        if bias:
            d["bias"] = torch.zeros(L, o, device=dev, dtype=dtype)
        return d

    return {
        "embed_tokens": dense(V, H),
        "layers": {
            "input_layernorm": torch.ones(L, H, device=dev, dtype=dtype),
            "q_proj": lin(H, tc.q_size),
            "k_proj": lin(H, tc.kv_size),
            "v_proj": lin(H, tc.kv_size),
            "o_proj": lin(tc.q_size, H, bias=False),
            "post_attention_layernorm": torch.ones(L, H, device=dev, dtype=dtype),
            "gate_proj": lin(H, I, bias=False),
            "up_proj": lin(H, I, bias=False),
            "down_proj": lin(I, H, bias=False),
        },
        "final_layernorm": torch.ones(H, device=dev, dtype=dtype),
    }


def init_params(
    cfg: Qwen25VLConfig,
    generator: torch.Generator,
    dtype: torch.dtype = torch.float32,
    device=DEFAULT_DEVICE,
) -> dict:
    """Random backbone tree (for the full-size bf16 model on the card, pass a
    CUDA generator and bf16)."""
    return {
        "visual": init_vision_params(cfg.vision, generator, dtype, device),
        "text": init_text_params(cfg.text, generator, dtype, device),
    }


# ------------------------------------------------------------------ vision


def _vision_rope(rot_pos: torch.Tensor, head_dim: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """rot_pos (B, P, 2) -> fp32 cos/sin (B, P, head_dim): the per-patch
    frequency vector [h*invf, w*invf], duplicated (``qwen25_vl.py:127-137``)."""
    quarter = head_dim // 4
    dev = rot_pos.device
    exponent = torch.arange(0, quarter, dtype=torch.float32, device=dev) / quarter
    inv_freq = 1.0 / torch.pow(torch.tensor(10000.0, dtype=torch.float32, device=dev), exponent)
    freqs = rot_pos.float()[..., None] * inv_freq  # (B, P, 2, quarter)
    half = freqs.reshape(*freqs.shape[:2], -1)  # (B, P, head_dim // 2)
    emb = torch.cat([half, half], dim=-1)
    return torch.cos(emb), torch.sin(emb)


def _vision_block(h, lp, vc: QwenVisionConfig, cos, sin, patch_valid, is_full: bool,
                  attn_impl: str, tp=None):
    """One vision block (``qwen25_vl.py:145-190``). ``patch_valid`` holds
    segment ids (0 = pad): a full block attends within one segment, a
    window block within its window's valid patches. Under ``tp`` this rank's
    heads and MLP columns: qkv (each part's own slice), gate and up
    column-split, proj and down row-split."""
    B, P, H = h.shape
    nh, hd, wp = local_heads(vc.num_heads, tp), vc.head_dim, vc.win_patches

    x = enter(rms_norm(h, lp["norm1"], vc.rms_norm_eps), tp)
    qkv = column(x, lp["qkv"]["kernel"], lp["qkv"]["bias"], tp=tp,
                 parts=(H,) * 3).reshape(B, P, 3, nh, hd)
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    q, k = (t.to(h.dtype) for t in apply_rotary(q.float(), k.float(), cos, sin))

    if is_full:
        attn = mha(q, k, v, causal=False, key_padding_mask=patch_valid, impl=attn_impl,
                   mask_layout="segments")
    else:
        nW = P // wp
        attn = mha(
            q.reshape(B * nW, wp, nh, hd), k.reshape(B * nW, wp, nh, hd),
            v.reshape(B * nW, wp, nh, hd), causal=False,
            key_padding_mask=patch_valid.reshape(B * nW, wp), impl=attn_impl,
            mask_layout="arbitrary",
        ).reshape(B, P, nh, hd)
    h = h + row(attn.reshape(B, P, nh * hd), lp["proj"]["kernel"], lp["proj"]["bias"], tp=tp)

    x = enter(rms_norm(h, lp["norm2"], vc.rms_norm_eps), tp)
    mlp = lp["mlp"]
    cols = dict(tp=tp, parts=(vc.intermediate_size,))
    gate = column(x, mlp["gate"]["kernel"], mlp["gate"]["bias"], **cols)
    up = column(x, mlp["up"]["kernel"], mlp["up"]["bias"], **cols)
    return h + row(silu(gate) * up, mlp["down"]["kernel"], mlp["down"]["bias"], tp=tp)


def vision_forward(
    params: dict,
    vc: QwenVisionConfig,
    patches: torch.Tensor,  # (B, P, patch_dim), window-ordered + padded; float or uint8
    patch_valid: torch.Tensor,  # (B, P) segment ids
    rot_pos: torch.Tensor,  # (B, P, 2)
    unit_gather: torch.Tensor,  # (B, U) original unit -> windowed unit
    num_units: torch.Tensor,  # (B,)
    *,
    attn_impl: str = "auto",
    remat: bool = False,
    tp=None,
) -> torch.Tensor:
    """-> (B, U, out_hidden) merged vision tokens in the original unit order,
    zero on invalid slots (``qwen25_vl.py:193-253``). Under ``tp`` the blocks
    run split; the merger is whole on every rank."""
    B, P, _ = patches.shape
    mm2 = vc.spatial_merge_size ** 2
    if patches.dtype == torch.uint8:
        # device-side preprocessing: CLIP normalisation in the patch-flat
        # (C, tps, ph, pw) order, pad slots (u8 zeros) kept zero
        mean, std = (torch.from_numpy(a).to(patches.device) for a in patch_norm_vectors(
            vc.in_channels, vc.temporal_patch_size, vc.patch_size))
        patches = (patches.float() / 255.0 - mean) / std
        patches = patches * (patch_valid != 0)[..., None]
        patches = patches.to(params["patch_embed"].dtype)
    h = mm(patches, params["patch_embed"])  # (B, P, H)
    cos, sin = _vision_rope(rot_pos, vc.head_dim)

    full = set(vc.fullatt_block_indexes)
    for i in range(vc.depth):
        h = stacked_layer(_vision_block, i, h, params["blocks"], vc, cos, sin, patch_valid,
                          i in full, attn_impl, remat=remat, tp=tp)

    # merger in window order (Qwen2_5_VLPatchMerger)
    m = params["merger"]
    x = rms_norm(h, m["ln_q"], vc.rms_norm_eps).reshape(B, P // mm2, mm2 * vc.hidden_size)
    # mm: a trainable fp32 merger over a bf16 tower computes in fp32, as jnp
    x = gelu(mm(x, m["fc1"]["kernel"]) + m["fc1"]["bias"])
    x = mm(x, m["fc2"]["kernel"]) + m["fc2"]["bias"]  # (B, U_w, out)

    out = _take_rows(x, unit_gather)  # original merged order
    slot = torch.arange(out.shape[1], device=out.device)[None, :]
    return torch.where((slot < num_units[:, None])[..., None], out,
                       torch.zeros((), dtype=out.dtype, device=out.device))


# ------------------------------------------------------------------ decoder


def _mrope_cos_sin(
    position_ids: torch.Tensor,  # (3, B, S)
    tc: QwenTextConfig,
    dtype: torch.dtype,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """M-RoPE (``qwen25_vl.py:258-282``): rope per axis (t, h, w), then the
    channels taken from the axes in the ``mrope_section * 2`` pattern."""
    hd = tc.head_dim
    half = hd // 2
    dev = position_ids.device
    exponent = torch.arange(0, half, dtype=torch.float32, device=dev) / half
    inv_freq = 1.0 / torch.pow(torch.tensor(tc.rope_theta, dtype=torch.float32, device=dev),
                               exponent)
    freqs = position_ids.float()[..., None] * inv_freq  # (3, B, S, half)
    emb = torch.cat([freqs, freqs], dim=-1)  # (3, B, S, hd)
    sections = list(tc.mrope_section) * 2
    axis_map = torch.cat([torch.full((n,), i % 3, dtype=torch.long, device=dev)
                          for i, n in enumerate(sections)])
    if axis_map.shape[0] != hd:
        raise ValueError(f"mrope_section {tc.mrope_section} does not cover head_dim {hd}")
    idx = axis_map.expand(1, *emb.shape[1:3], hd)
    cos = torch.gather(torch.cos(emb), 0, idx)[0]
    sin = torch.gather(torch.sin(emb), 0, idx)[0]
    return cos.to(dtype), sin.to(dtype)


def fuse_decoder_projections(layers: dict) -> dict:
    """q/k/v -> ``qkv_proj`` and gate/up -> ``gate_up_proj`` in a stacked
    decoder-layer tree (``qwen25_vl.py:306-333``), concatenated on the out
    axis: dense kernels, biases and quantized leaf dicts (codes and their
    per-out-column scales) alike, so fusing after quantization is exact; W8A8
    codes stay K-major (``utils/quantize.cat_out``). Call after any LoRA
    merge: the fused layout takes no adapters."""
    out = dict(layers)
    if all(n in out for n in ("q_proj", "k_proj", "v_proj")):
        out["qkv_proj"] = cat_out([out.pop("q_proj"), out.pop("k_proj"), out.pop("v_proj")])
    if all(n in out for n in ("gate_proj", "up_proj")):
        out["gate_up_proj"] = cat_out([out.pop("gate_proj"), out.pop("up_proj")])
    return out


def _decoder_layer(h, lp, tc: QwenTextConfig, cos, sin, attention_mask, attn_impl,
                   lora_layer=None, tp=None):
    """One decoder layer (``qwen25_vl.py:336-435``), either layout. Under
    ``tp`` this rank's heads (GQA: its query heads with their kv heads) and
    MLP columns: q/k/v (or qkv), gate/up (or gate_up) column-split, o and
    down row-split."""
    lp = dequant_layer(lp, h.dtype)  # no-op unless weight-only quantized
    B, S, _ = h.shape
    nh, nkv, hd = local_heads(tc.num_heads, tp), local_heads(tc.num_kv_heads, tp), tc.head_dim
    eps = tc.rms_norm_eps
    # attn_impl="plain" sends the epilogues and the int8 GEMM to their plain
    # versions too; "pallas" forces their route on any device
    plain = attn_impl == "plain"
    use_rq = lora_layer is None and (attn_impl == "pallas" or on_card(h)) and qe.supported(h)

    def rq_lin(hid, gamma, proj, parts):
        # B4 on the whole row (the same on every tp rank) into this rank's columns
        codes, rs = (qe.rms_quant_plain if plain else qe.rms_quant)(hid, gamma, eps)
        out = int8_linear_pre(codes, rs, local_cols(proj["kernel"], tp, parts), hid.dtype, plain)
        return out + local_cols(proj["bias"], tp, parts) if "bias" in proj else out

    def col(x, name, parts):
        p = lp[name]
        return column(x, p["kernel"], p.get("bias"), lora_of(lora_layer, name), tp=tp,
                      parts=parts, plain=plain)

    residual = h
    if "qkv_proj" in lp:
        qkv_parts = (tc.q_size, tc.kv_size, tc.kv_size)
        if use_rq and is_w8a8(lp["qkv_proj"]["kernel"]):
            qkv = rq_lin(h, lp["input_layernorm"], lp["qkv_proj"], qkv_parts)
        else:
            qkv = col(enter(rms_norm(h, lp["input_layernorm"], eps), tp), "qkv_proj", qkv_parts)
        attn = fused_rope_attention(
            qkv, cos, sin, n_heads=nh, n_kv_heads=nkv, head_dim=hd, causal=True,
            key_padding_mask=attention_mask, sliding_window=tc.sliding_window,
            impl=attn_impl,
        )
    else:
        x = enter(rms_norm(h, lp["input_layernorm"], eps), tp)
        q = col(x, "q_proj", (tc.q_size,))
        k = col(x, "k_proj", (tc.kv_size,))
        v = col(x, "v_proj", (tc.kv_size,))
        q, k = apply_rotary(q.reshape(B, S, nh, hd), k.reshape(B, S, nkv, hd), cos, sin)
        v = v.reshape(B, S, nkv, hd)
        attn = mha(
            q, k, v, causal=True, key_padding_mask=attention_mask,
            sliding_window=tc.sliding_window, impl=attn_impl,
        ).reshape(B, S, nh * hd)
    attn = row(attn, lp["o_proj"]["kernel"], lp["o_proj"].get("bias"),
               lora_of(lora_layer, "o_proj"), tp=tp, plain=plain)
    h = residual + attn

    residual = h
    if "gate_up_proj" in lp:
        gate_up_parts = (tc.intermediate_size,) * 2
        if use_rq and is_w8a8(lp["gate_up_proj"]["kernel"]):
            gate_up = rq_lin(h, lp["post_attention_layernorm"], lp["gate_up_proj"],
                             gate_up_parts)
        else:
            x = enter(rms_norm(h, lp["post_attention_layernorm"], eps), tp)
            gate_up = col(x, "gate_up_proj", gate_up_parts)
        if use_rq and is_w8a8(lp["down_proj"]["kernel"]) \
                and local_heads(tc.intermediate_size, tp) % 128 == 0:
            # silu(gate)*up straight to int8 codes for down_proj (under tp on
            # the tp-global amax, this rank's K-block)
            mlp = row_silu_mul(gate_up, lp["down_proj"]["kernel"], lp["down_proj"].get("bias"),
                               tp=tp, plain=plain)
            return residual + mlp
        gate, up = torch.chunk(gate_up, 2, dim=-1)
    else:
        x = enter(rms_norm(h, lp["post_attention_layernorm"], eps), tp)
        gate = col(x, "gate_proj", (tc.intermediate_size,))
        up = col(x, "up_proj", (tc.intermediate_size,))
    mlp = silu(gate) * up
    mlp = row(mlp, lp["down_proj"]["kernel"], lp["down_proj"].get("bias"),
              lora_of(lora_layer, "down_proj"), tp=tp, plain=plain)
    return residual + mlp


class QwenOutput(NamedTuple):
    last_hidden_state: torch.Tensor
    collected_hidden_state: Optional[torch.Tensor]
    vision_embedding: Optional[torch.Tensor]  # (B, U, H) zero on invalid slots


def text_forward(
    params: dict,
    tc: QwenTextConfig,
    inputs_embeds: torch.Tensor,
    attention_mask: torch.Tensor,
    position_ids: torch.Tensor,  # (3, B, S)
    *,
    collect_layer_id: Optional[int] = None,
    attn_impl: str = "auto",
    remat: bool = False,
    lora: Optional[dict] = None,
    tp=None,
):
    """-> (post-final-norm last hidden state, the collected pre-norm layer
    output or None) (``qwen25_vl.py:444-480``); the layers split under
    ``tp``."""
    cos, sin = _mrope_cos_sin(position_ids, tc, inputs_embeds.dtype)
    collect = collect_layer_id is not None and collect_layer_id < tc.num_layers
    collected = inputs_embeds if collect else None

    h = inputs_embeds
    for i in range(tc.num_layers):
        h = stacked_layer(_decoder_layer, i, h, params["layers"], tc, cos, sin, attention_mask,
                          attn_impl, lora=lora, remat=remat, tp=tp)
        if collect and i + 1 == collect_layer_id:
            collected = h
    return rms_norm(h, params["final_layernorm"], tc.rms_norm_eps), collected


def forward(
    params: dict,
    cfg: Qwen25VLConfig,
    input_ids: torch.Tensor,  # (B, S)
    attention_mask: torch.Tensor,
    position_ids: torch.Tensor,  # (3, B, S)
    patches: Optional[torch.Tensor],  # (B, P, patch_dim) windowed
    patch_valid: Optional[torch.Tensor],
    rot_pos: Optional[torch.Tensor],
    unit_gather: Optional[torch.Tensor],
    splice_idx: Optional[torch.Tensor],  # (B, S)
    num_img_tokens: Optional[torch.Tensor],  # (B,) merged units
    *,
    collect_layer_id: Optional[int] = None,
    attn_impl: str = "auto",
    remat: bool = False,
    lora: Optional[dict] = None,
    tp=None,
) -> QwenOutput:
    """``qwen25_vl.py:483-520``. uint8 patches reach ``vision_forward`` as
    they are, which normalises them on the device (the JAX function casts
    them to the compute dtype first, which skips that normalisation)."""
    embeds = params["text"]["embed_tokens"][input_ids.long()]
    dtype = embeds.dtype

    vision_embedding = None
    if patches is not None:
        if patches.dtype != torch.uint8:
            patches = patches.to(dtype)
        vision_embedding = vision_forward(
            params["visual"], cfg.vision, patches, patch_valid, rot_pos, unit_gather,
            num_img_tokens, attn_impl=attn_impl, remat=remat, tp=tp,
        ).to(dtype)
        k = torch.clamp(splice_idx, 0, vision_embedding.shape[1] - 1)
        spliced = _take_rows(vision_embedding, k)
        embeds = torch.where((splice_idx >= 0)[..., None], spliced, embeds)

    last, collected = text_forward(
        params["text"], cfg.text, embeds, attention_mask, position_ids,
        collect_layer_id=collect_layer_id, attn_impl=attn_impl, remat=remat, lora=lora, tp=tp,
    )
    return QwenOutput(last, collected, vision_embedding)
