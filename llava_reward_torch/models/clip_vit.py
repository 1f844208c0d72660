"""CLIP ViT vision tower (ViT-L/14-336 for Phi-3.5-V).

Counterpart of ``llava_reward_tpu/models/clip_vit.py``: penultimate-layer
patch features with the CLS token dropped; the patch "conv" is a reshape and
one matmul; layers stacked on a leading axis (a Python loop takes the place
of ``lax.scan``); only ``num_active_layers`` layers run.

Param tree (linear kernels stored (in, out)):
  {'class_embedding': (H,), 'patch_proj': (P*P*C, H),
   'position_embedding': (577, H), 'pre_layernorm': {'weight','bias'},
   'layers': {'ln1','ln2': {'weight','bias'},
              'attn': {'q'|'k'|'v'|'out': {'kernel','bias'}},
              'mlp': {'fc1'|'fc2': {'kernel','bias'}}},   # leading axis L
   'post_layernorm': {'weight','bias'}}
"""

from __future__ import annotations

from typing import Optional

import torch

from ..core.config import VisionConfig
from ..core.device import DEFAULT_DEVICE, on_card, resolve_device
from ..ops.activations import ACT2FN
from ..ops.attention import mha
from ..ops.norms import layer_norm
from ..utils.quantize import is_w8a8


def init_params(
    cfg: VisionConfig,
    generator: torch.Generator,
    dtype: torch.dtype = torch.float32,
    device=DEFAULT_DEVICE,
) -> dict:
    """Random init (normal, std 0.02) drawn from ``generator`` on ``device``."""
    dev = resolve_device(device)
    H, I, L = cfg.hidden_size, cfg.intermediate_size, cfg.num_layers
    P, C = cfg.patch_size, cfg.num_channels

    def dense(*shape):
        w = torch.randn(*shape, generator=generator, device=dev, dtype=dtype)
        return w.mul_(0.02)

    def ones(*shape):
        return torch.ones(*shape, device=dev, dtype=dtype)

    def zeros(*shape):
        return torch.zeros(*shape, device=dev, dtype=dtype)

    def stacked(in_dim, out_dim):
        return {"kernel": dense(L, in_dim, out_dim), "bias": zeros(L, out_dim)}

    return {
        "class_embedding": dense(H),
        "patch_proj": dense(P * P * C, H),
        "position_embedding": dense(cfg.num_positions, H),
        "pre_layernorm": {"weight": ones(H), "bias": zeros(H)},
        "layers": {
            "ln1": {"weight": ones(L, H), "bias": zeros(L, H)},
            "ln2": {"weight": ones(L, H), "bias": zeros(L, H)},
            "attn": {n: stacked(H, H) for n in ("q", "k", "v", "out")},
            "mlp": {"fc1": stacked(H, I), "fc2": stacked(I, H)},
        },
        "post_layernorm": {"weight": ones(H), "bias": zeros(H)},
    }


def embed_patches(params: dict, cfg: VisionConfig, pixel_values: torch.Tensor) -> torch.Tensor:
    """pixel_values (N, H_img, W_img, C) channels-last -> (N, 1+patches, H)."""
    N, Himg, Wimg, C = pixel_values.shape
    P = cfg.patch_size
    gh, gw = Himg // P, Wimg // P
    x = pixel_values.reshape(N, gh, P, gw, P, C)
    x = x.permute(0, 1, 3, 2, 4, 5).reshape(N, gh * gw, P * P * C)
    patches = x @ params["patch_proj"]
    cls = params["class_embedding"].to(patches.dtype).expand(N, 1, cfg.hidden_size)
    emb = torch.cat([cls, patches], dim=1)
    return emb + params["position_embedding"][None].to(patches.dtype)


def _lora_delta(x, lora_layer, name):
    """LoRA hook of ``clip_vit.py:99-105``; a no-op while ``lora is None``
    (adapter merge and vision LoRA arrive with later slices)."""
    if lora_layer is None or name not in lora_layer:
        return 0.0
    t = lora_layer[name]
    return (x @ t["a"].to(x.dtype)) @ t["b"].to(x.dtype) * t["scale"].to(x.dtype)


def _encoder_layer(h, lp, cfg: VisionConfig, attn_impl: str, lora_layer=None, valid_len=None):
    """One encoder layer (``clip_vit.py:108-216``, bf16 path)."""
    act = ACT2FN[cfg.hidden_act]
    nh, hd = cfg.num_heads, cfg.head_dim
    N, S, H = h.shape
    a = lp["attn"]

    residual = h
    x = layer_norm(h, lp["ln1"]["weight"], lp["ln1"]["bias"], cfg.layer_norm_eps)
    if attn_impl in ("fused", "fused_plain"):
        # fused qkv matmul + the direct kernel (B1), or its plain version on
        # any device: output comes back as (N, S, H); pad keys at or beyond
        # valid_len are masked in-kernel
        from ..ops.flash_attention import direct_attention, fa_direct_plain

        wk = torch.cat([a["q"]["kernel"], a["k"]["kernel"], a["v"]["kernel"]], dim=1)
        wb = torch.cat([a["q"]["bias"], a["k"]["bias"], a["v"]["bias"]])
        qkv = x @ wk + wb
        if lora_layer is not None:
            deltas = [_lora_delta(x, lora_layer, n) for n in ("q", "k", "v")]
            if any(not isinstance(d, float) for d in deltas):
                qkv = qkv + torch.cat(
                    [torch.zeros_like(x) if isinstance(d, float) else d for d in deltas],
                    dim=-1,
                )
        direct = fa_direct_plain if attn_impl == "fused_plain" else direct_attention
        attn = direct(
            qkv, None, None, torch.zeros(N, dtype=torch.int32, device=h.device),
            n_heads=nh, head_dim=hd, causal=False, sliding_window=None,
            scale=hd ** -0.5, valid_len=valid_len,
        )
    else:
        q = x @ a["q"]["kernel"] + a["q"]["bias"] + _lora_delta(x, lora_layer, "q")
        k = x @ a["k"]["kernel"] + a["k"]["bias"] + _lora_delta(x, lora_layer, "k")
        v = x @ a["v"]["kernel"] + a["v"]["bias"] + _lora_delta(x, lora_layer, "v")
        q = q.reshape(N, S, nh, hd)
        k = k.reshape(N, S, nh, hd)
        v = v.reshape(N, S, nh, hd)
        attn = mha(q, k, v, causal=False, impl=attn_impl).reshape(N, S, H)
    attn_out = attn @ a["out"]["kernel"] + a["out"]["bias"] + _lora_delta(attn, lora_layer, "out")
    h = residual + attn_out

    residual = h
    x = layer_norm(h, lp["ln2"]["weight"], lp["ln2"]["bias"], cfg.layer_norm_eps)
    x1 = act(
        x @ lp["mlp"]["fc1"]["kernel"] + lp["mlp"]["fc1"]["bias"]
        + _lora_delta(x, lora_layer, "fc1")
    )
    x2 = (
        x1 @ lp["mlp"]["fc2"]["kernel"] + lp["mlp"]["fc2"]["bias"]
        + _lora_delta(x1, lora_layer, "fc2")
    )
    return residual + x2


def layer_slice(tree, i):
    """Layer ``i`` of a stacked tree: every leaf, also inside nested dicts
    (quantized leaves, LoRA factors), indexed on its leading axis."""
    if isinstance(tree, dict):
        return {k: layer_slice(v, i) for k, v in tree.items()}
    return tree[i]


def _refuse_w8a8(tree) -> None:
    if isinstance(tree, dict):
        if is_w8a8(tree):
            raise NotImplementedError(
                "W8A8 CLIP weights need the LayerNorm quantizing epilogue "
                "(_ln_quant_kernel), which is ROADMAP B9; the tower runs in bf16"
            )
        for v in tree.values():
            _refuse_w8a8(v)


def extract_patch_features(
    params: dict,
    cfg: VisionConfig,
    pixel_values: torch.Tensor,  # (N, H_img, W_img, C)
    *,
    attn_impl: str = "auto",
    lora: Optional[dict] = None,
) -> torch.Tensor:
    """Penultimate-layer patch features, CLS dropped: (N, num_patches, H)
    (``clip_vit.py:226-279``). W8A8 weights raise (ROADMAP B9)."""
    _refuse_w8a8(params["layers"])
    h = embed_patches(params, cfg, pixel_values)
    h = layer_norm(
        h, params["pre_layernorm"]["weight"], params["pre_layernorm"]["bias"],
        cfg.layer_norm_eps,
    )
    n_active = cfg.num_active_layers

    # on the card: pad the token axis to a 64 multiple and run the fused
    # qkv + direct kernel layer, pad keys masked by valid_len (:252-268)
    S = h.shape[1]
    valid_len = None
    if (
        attn_impl in ("auto", "pallas", "plain")
        and on_card(h)
        and S % 64 != 0
        and lora is None
    ):
        from ..ops.flash_attention import _direct_group

        if _direct_group(cfg.num_heads, cfg.head_dim) is not None:
            S_pad = (S + 63) // 64 * 64
            h = torch.nn.functional.pad(h, (0, 0, 0, S_pad - S))
            valid_len = S
            attn_impl = "fused_plain" if attn_impl == "plain" else "fused"

    for i in range(n_active):
        lora_layer = layer_slice(lora, i) if lora is not None else None
        h = _encoder_layer(h, layer_slice(params["layers"], i), cfg, attn_impl,
                           lora_layer, valid_len)
    return h[:, 1:S, :]  # drop CLS (and the pad tail)
