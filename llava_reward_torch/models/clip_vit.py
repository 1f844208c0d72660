"""CLIP ViT vision tower (ViT-L/14-336 for Phi-3.5-V).

Counterpart of ``llava_reward_tpu/models/clip_vit.py``: penultimate-layer
patch features with the CLS token dropped; the patch "conv" is a reshape and
one matmul; layers stacked on a leading axis (a Python loop takes the place
of ``lax.scan``); only ``num_active_layers`` layers run.

Projection leaves may be W8A8 (``quantize_stacked_layers(clip["layers"],
scheme="w8a8")``; no entry point quantizes the tower, in the JAX package
neither): they run through the int8 GEMM. With no LoRA and a 128-multiple
width, the kernel route (on the card, or ``attn_impl="pallas"``) takes the
activation codes of qkv (fused route only) and fc1 straight from the
LayerNorm quantizing epilogue (``ops/quant_epilogue.ln_quant``, B9);
``out`` and ``fc2`` quantize their input dynamically (B6 + the GEMM). Under
tp, B9's codes are the whole row's, into the rank's q/k/v and fc1 columns,
and out / fc2 take their codes on the tp-global amax
(``parallel/tensor.row``).

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
from torch.utils.checkpoint import checkpoint

from ..core.config import VisionConfig
from ..core.device import DEFAULT_DEVICE, on_card, resolve_device
from ..ops import quant_epilogue as qe
from ..ops.activations import ACT2FN
from ..ops.attention import mha
from ..ops.linear import mm
from ..ops.norms import layer_norm
from ..parallel.sharding import Sharded
from ..parallel.tensor import column, enter, local_cols, local_heads, lora_of, row
from ..utils.quantize import cat_out, int8_linear_pre, is_w8a8, qmatmul


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
    patches = mm(x, params["patch_proj"])
    cls = params["class_embedding"].to(patches.dtype).expand(N, 1, cfg.hidden_size)
    emb = torch.cat([cls, patches], dim=1)
    return emb + params["position_embedding"][None].to(patches.dtype)


def _encoder_layer(h, lp, cfg: VisionConfig, attn_impl: str, lora_layer=None, valid_len=None,
                   quant_route: bool = False, tp=None):
    """One encoder layer (``clip_vit.py:108-216``). ``quant_route``: the
    caller asked for the kernel route by name (``attn_impl="pallas"`` /
    ``"plain"``), which turns the LayerNorm quantizing epilogue on off the
    card too; ``attn_impl`` itself may already read ``"fused"``. Under ``tp``
    this rank's heads and MLP columns: q/k/v and fc1 column-split, out and
    fc2 row-split (``parallel/tensor.py``)."""
    act = ACT2FN[cfg.hidden_act]
    nh, hd = local_heads(cfg.num_heads, tp), cfg.head_dim
    N, S, H = h.shape
    a = lp["attn"]
    eps = cfg.layer_norm_eps
    # the plain route sends the epilogue and the int8 GEMM to their plain
    # versions too, as models/phi3.decoder_layer does
    plain = attn_impl in ("plain", "fused_plain")
    fused = attn_impl in ("fused", "fused_plain")
    use_ln_quant = lora_layer is None and (quant_route or on_card(h)) and qe.supported(h)
    ln_q = qe.ln_quant_plain if plain else qe.ln_quant

    residual = h
    x = None
    if use_ln_quant and is_w8a8(a["q"]["kernel"]) and fused:
        x_codes, x_rs = ln_q(h, lp["ln1"]["weight"], lp["ln1"]["bias"], eps)
    else:
        x = enter(layer_norm(h, lp["ln1"]["weight"], lp["ln1"]["bias"], eps), tp)
    if fused:
        # fused qkv matmul + the direct kernel (B1), or its plain version on
        # any device: output comes back as (N, S, H); pad keys at or beyond
        # valid_len are masked in-kernel. The route takes no LoRA
        # (``extract_patch_features``)
        from ..ops.flash_attention import direct_attention, fa_direct_plain

        # W8A8: codes (K-major) and per-channel scales concatenated on the out
        # axis, so the fused projection is ONE int8 GEMM; per layer and call,
        # as in the JAX package (3 MB of codes at ViT-L)
        wk = cat_out([local_cols(a[n]["kernel"], tp, (H,)) for n in ("q", "k", "v")])
        wb = torch.cat([local_cols(a[n]["bias"], tp, (H,)) for n in ("q", "k", "v")])
        if x is None:
            qkv = int8_linear_pre(x_codes, x_rs, wk, h.dtype, plain) + wb
        else:
            qkv = qmatmul(x, wk, plain) + wb
        direct = fa_direct_plain if plain else direct_attention
        attn = direct(
            qkv, None, None, torch.zeros(N, dtype=torch.int32, device=h.device),
            n_heads=nh, head_dim=hd, causal=False, sliding_window=None,
            scale=hd ** -0.5, valid_len=valid_len,
        )
    else:
        q, k, v = (
            column(x, a[n]["kernel"], a[n]["bias"], lora_of(lora_layer, n), tp=tp, parts=(H,),
                   plain=plain).reshape(N, S, nh, hd)
            for n in ("q", "k", "v")
        )
        attn = mha(q, k, v, causal=False, impl=attn_impl).reshape(N, S, nh * hd)
    attn_out = row(attn, a["out"]["kernel"], a["out"]["bias"], lora_of(lora_layer, "out"),
                   tp=tp, plain=plain)
    h = residual + attn_out

    residual = h
    fc1, fc2 = lp["mlp"]["fc1"], lp["mlp"]["fc2"]
    if use_ln_quant and is_w8a8(fc1["kernel"]):
        x_codes, x_rs = ln_q(h, lp["ln2"]["weight"], lp["ln2"]["bias"], eps)
        I = cfg.intermediate_size
        x1 = act(int8_linear_pre(x_codes, x_rs, local_cols(fc1["kernel"], tp, (I,)), h.dtype,
                                 plain) + local_cols(fc1["bias"], tp, (I,)))
    else:
        x = enter(layer_norm(h, lp["ln2"]["weight"], lp["ln2"]["bias"], eps), tp)
        x1 = act(column(x, fc1["kernel"], fc1["bias"], lora_of(lora_layer, "fc1"), tp=tp,
                        parts=(cfg.intermediate_size,), plain=plain))
    x2 = row(x1, fc2["kernel"], fc2["bias"], lora_of(lora_layer, "fc2"), tp=tp, plain=plain)
    return residual + x2


def layer_slice(tree, i):
    """Layer ``i`` of a stacked tree: every leaf, also inside nested dicts
    (quantized leaves, LoRA factors), indexed on its leading axis. A leaf
    sharded over the mesh's fsdp axis (``parallel/sharding.Sharded``) is
    all-gathered here, layer ``i`` alone, under autograd."""
    if isinstance(tree, dict):
        return {k: layer_slice(v, i) for k, v in tree.items()}
    if isinstance(tree, Sharded):
        return tree.layer(i)
    return tree[i]


def _sliced(fn, i, h, layers, lora, *rest, **kw):
    if lora is not None:
        kw["lora_layer"] = layer_slice(lora, i)
    return fn(h, layer_slice(layers, i), *rest, **kw)


def stacked_layer(fn, i, h, layers, *rest, lora=None, remat=False, **kw):
    """``fn(h, layer i of layers, *rest, lora_layer=layer i of lora, **kw)``.
    The slice, and so a sharded layer's gather, happens inside the
    checkpointed region under ``remat``: the gathered weights are dropped
    after the forward and gathered again for the backward's recompute,
    instead of being kept as checkpoint inputs."""
    if remat:
        return checkpoint(_sliced, fn, i, h, layers, lora, *rest, use_reentrant=False, **kw)
    return _sliced(fn, i, h, layers, lora, *rest, **kw)


def extract_patch_features(
    params: dict,
    cfg: VisionConfig,
    pixel_values: torch.Tensor,  # (N, H_img, W_img, C)
    *,
    attn_impl: str = "auto",
    remat: bool = False,
    lora: Optional[dict] = None,
    tp=None,
) -> torch.Tensor:
    """Penultimate-layer patch features, CLS dropped: (N, num_patches, H)
    (``clip_vit.py:226-279``). With a
    vision LoRA tree the tower stays on the differentiable ``mha`` route
    (B3 forward, B8 backward on the card): the direct kernel (B1) has no
    backward, in the JAX package neither (``clip_vit.py:256-258``). With
    ``remat`` each layer runs under ``torch.utils.checkpoint``
    (``clip_vit.py:270-272``). Under ``tp`` each rank runs its own heads
    (``_encoder_layer``), B1's head-group rule read on them."""
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
    quant_route = attn_impl in ("pallas", "plain")
    if (
        attn_impl in ("auto", "pallas", "plain")
        and on_card(h)
        and S % 64 != 0
        and lora is None
    ):
        from ..ops.flash_attention import _direct_group

        if _direct_group(local_heads(cfg.num_heads, tp), cfg.head_dim) is not None:
            S_pad = (S + 63) // 64 * 64
            h = torch.nn.functional.pad(h, (0, 0, 0, S_pad - S))
            valid_len = S
            attn_impl = "fused_plain" if attn_impl == "plain" else "fused"

    for i in range(n_active):
        h = stacked_layer(_encoder_layer, i, h, params["layers"], cfg, attn_impl, lora=lora,
                          remat=remat, valid_len=valid_len, quant_route=quant_route, tp=tp)
    return h[:, 1:S, :]  # drop CLS (and the pad tail)
