"""Quantized decoder weights: the weight-only schemes and W8A8.

Counterpart of ``llava_reward_tpu/utils/quantize.py``, on tensors. The
quantizers run on the device their input lies on (the full Phi-3.5-vision
decoder is 3.6 G weights) and give the JAX package's codes and scales bit
for bit: fp32 arithmetic, round half to even, the same clip and packing.

- Weight-only: int8 / int4 per-output-channel absmax
  (``{'qvalues_i8' | 'qvalues_i4', 'scale'}``, int4 packed two per byte
  along 'in') and the bitsandbytes NF4 grid with 64-element blocks
  (``{'qvalues_nf4', 'scale'}``). ``dequant_layer`` turns them back into
  dense weights before the matmul, except packed int4, which runs as W8A8
  (its grid is a subset of the int8 codes).
- W8A8 (``--load_in_8bit``): ``{'qvalues_w8a8': int8 (in, out), 'scale':
  f32 (1, out)}`` leaves stay int8 in the matmul, which quantizes the
  activations per row; ``ops/int8_matmul.py`` holds that GEMM.

The JAX package's environment switches are not ported: the epilogues are
always on (``LRT_LN_QUANT``), int4 always runs as W8A8 (``LRT_I4_W8A8``),
and the int8 product is always the port's GEMM (``LRT_PALLAS_INT8``).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Sequence

import torch

from ..ops.int8_matmul import (
    int8_matmul_pre,
    int8_matmul_pre_plain,
    w8a8_matmul,
    w8a8_matmul_plain,
)
from ..ops.quant_epilogue import ieee_div

_Q8 = "qvalues_i8"
_Q4 = "qvalues_i4"  # two int4 packed per byte along the 'in' axis
_QNF4 = "qvalues_nf4"  # two nf4 codes packed per byte along the 'in' axis
_Q8A = "qvalues_w8a8"  # int8 weights run as int8 (dynamic per-row act quant)

# bitsandbytes NF4 grid: the 16 quantiles of N(0, 1) normalised to [-1, 1]
NF4_GRID = torch.tensor(
    [
        -1.0, -0.6961928009986877, -0.5250730514526367, -0.39491748809814453,
        -0.28444138169288635, -0.18477343022823334, -0.09105003625154495, 0.0,
        0.07958029955625534, 0.16093020141124725, 0.2461123913526535,
        0.33791524171829224, 0.44070982933044434, 0.5626170039176941,
        0.7229568362236023, 1.0,
    ],
    dtype=torch.float32,
)
_NF4_BOUNDARIES = (NF4_GRID[:-1] + NF4_GRID[1:]) / 2  # nearest-level decision
NF4_BLOCK = 64  # bnb default blocksize

QDict = Dict[str, torch.Tensor]


def _f32(w) -> torch.Tensor:
    return torch.as_tensor(w).float()


def _pack_nibbles(codes: torch.Tensor) -> torch.Tensor:
    """(..., in, out) codes -> (..., in/2, out) int8: low nibble of row 2i,
    high nibble of row 2i+1."""
    c = codes.to(torch.int32)
    packed = (c[..., 0::2, :] & 0x0F) | ((c[..., 1::2, :] & 0x0F) << 4)
    return packed.to(torch.uint8).view(torch.int8)


def _unpack_i4_codes(q: torch.Tensor) -> torch.Tensor:
    """Packed int4 (..., in/2, out) -> sign-extended int8 codes (..., in, out)."""
    c = q.to(torch.int32)
    lo = ((c & 0x0F) ^ 8) - 8
    hi = c >> 4
    codes = torch.stack([lo, hi], dim=-2)
    return codes.reshape(*q.shape[:-2], q.shape[-2] * 2, q.shape[-1]).to(torch.int8)


def quantize_array_nf4(w, block: int = NF4_BLOCK) -> QDict:
    """(..., in, out) float -> {'qvalues_nf4', 'scale'}: per-``block`` absmax
    along 'in', codes = nearest of the 16 NF4 levels, two packed per byte."""
    wf = _f32(w)
    n_in, n_out = wf.shape[-2], wf.shape[-1]
    if n_in % block:
        raise ValueError(f"nf4: 'in' = {n_in} is not a multiple of the block {block}")
    lead = wf.shape[:-2]
    nb = n_in // block
    wb = wf.reshape(*lead, nb, block, n_out)
    absmax = wb.abs().amax(dim=-2, keepdim=True)  # (..., nb, 1, out)
    scale = torch.where(absmax > 0, absmax, 1.0)
    norm = wb / scale  # in [-1, 1]
    codes = torch.searchsorted(_NF4_BOUNDARIES.to(wf.device), norm.reshape(-1))
    return {
        _QNF4: _pack_nibbles(codes.reshape(*lead, n_in, n_out)),
        "scale": scale.reshape(*lead, nb, n_out),
    }


def dequantize_array_nf4(qd: QDict, dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    q = qd[_QNF4].to(torch.int32)
    lo = q & 0x0F
    hi = (q >> 4) & 0x0F
    codes = torch.stack([lo, hi], dim=-2).reshape(*q.shape[:-2], q.shape[-2] * 2, q.shape[-1])
    vals = NF4_GRID.to(q.device)[codes]
    lead = vals.shape[:-2]
    n_in, n_out = vals.shape[-2], vals.shape[-1]
    nb = qd["scale"].shape[-2]
    vals = vals.reshape(*lead, nb, n_in // nb, n_out) * qd["scale"][..., :, None, :]
    return vals.reshape(*lead, n_in, n_out).to(dtype)


def _absmax_codes(w, qmax: float):
    wf = _f32(w)
    absmax = wf.abs().amax(dim=-2, keepdim=True)  # (..., 1, out)
    scale = torch.where(absmax > 0, ieee_div(absmax, qmax), 1.0)
    q = torch.clamp(torch.round(wf / scale), -qmax, qmax).to(torch.int8)
    return q, scale


def quantize_array(w, bits: int = 8) -> QDict:
    """(..., in, out) float -> {'qvalues_i8' | 'qvalues_i4', 'scale'}, per
    (leading, out) symmetric absmax."""
    if bits not in (8, 4):
        raise ValueError(f"bits must be 8 or 4, got {bits}")
    q, scale = _absmax_codes(w, 127.0 if bits == 8 else 7.0)
    if bits == 4:
        return {_Q4: _pack_nibbles(q), "scale": scale}
    return {_Q8: q, "scale": scale}


def dequantize_array(qd: QDict, dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    if _QNF4 in qd:
        return dequantize_array_nf4(qd, dtype)
    q = _unpack_i4_codes(qd[_Q4]) if _Q4 in qd else qd[_Q8]
    return (q.float() * qd["scale"]).to(dtype)


def is_quantized(leaf: Any) -> bool:
    return isinstance(leaf, dict) and (_Q8 in leaf or _Q4 in leaf or _QNF4 in leaf)


# ------------------------------------------------------------------ W8A8


def quantize_array_w8a8(w) -> QDict:
    """(..., in, out) float -> {'qvalues_w8a8', 'scale'}: symmetric int8 with
    per-(leading, out) scales; the weights stay int8 at run time."""
    q, scale = _absmax_codes(w, 127.0)
    return {_Q8A: q, "scale": scale}


def is_w8a8(leaf: Any) -> bool:
    return isinstance(leaf, dict) and _Q8A in leaf


def _int8_matmul_2d(x2, w, scale, plain: bool = False) -> torch.Tensor:
    """(M, in) x int8 (in, out): per-row absmax codes, s8 x s8 -> s32, then
    ``f32(y) * (amax / 127) * scale`` cast to x's dtype
    (``quantize.py:155-181``). The GEMM's kernel on the card, or with
    ``plain`` its plain version; its plain version on the CPU."""
    return (w8a8_matmul_plain if plain else w8a8_matmul)(x2, w, scale, x2.dtype)


class _Int8LinearCore(torch.autograd.Function):
    """``_int8_linear_core`` (``quantize.py:184-215``): straight-through
    with respect to the activation quantization; the int8 weights get no
    gradient (a frozen W8A8 base under LoRA)."""

    @staticmethod
    def forward(ctx, x2, w, scale, plain):
        ctx.save_for_backward(w, scale)
        return _int8_matmul_2d(x2, w, scale, plain)

    @staticmethod
    def backward(ctx, dy):
        # dx = (dy * scale) @ w^T with bf16 operands and an fp32 result; the
        # bf16 values are exact in fp32, so an fp32 product gives it
        w, scale = ctx.saved_tensors
        dys = (dy.float() * scale.reshape(1, -1)).to(torch.bfloat16).float()
        dx = torch.matmul(dys, w.float().t())
        return dx.to(dy.dtype), None, None, None


def int8_linear(x: torch.Tensor, qd: QDict, plain: bool = False) -> torch.Tensor:
    """x (..., in) @ W8A8 weight (in, out); differentiable in x."""
    lead = x.shape[:-1]
    y = _Int8LinearCore.apply(x.reshape(-1, x.shape[-1]), qd[_Q8A], qd["scale"], plain)
    return y.reshape(*lead, -1)


def int8_linear_pre(
    codes: torch.Tensor, rowscale: torch.Tensor, qd: QDict,
    dtype: torch.dtype = torch.bfloat16, plain: bool = False,
) -> torch.Tensor:
    """W8A8 matmul over pre-quantized activations (``quantize.py:228-250``):
    ``codes`` (..., in) int8 and ``rowscale`` (..., 1), the row amax the
    epilogues emit (divided by 127 here). Inference only."""
    lead = codes.shape[:-1]
    fn = int8_matmul_pre_plain if plain else int8_matmul_pre
    y = fn(codes.reshape(-1, codes.shape[-1]), rowscale.reshape(-1, 1), qd[_Q8A],
           qd["scale"], dtype)
    return y.reshape(*lead, -1)


def qmatmul(x: torch.Tensor, w, plain: bool = False) -> torch.Tensor:
    """The int8 path for a W8A8 leaf, a plain matmul otherwise (weight-only
    schemes were already dequantized by ``dequant_layer``)."""
    if is_w8a8(w):
        return int8_linear(x, w, plain)
    return x @ w


def _per_layer(fn: Callable[[torch.Tensor], QDict], w: torch.Tensor) -> QDict:
    """``fn`` one leading slice at a time (every scale is per slice), which
    bounds the fp32 working set to one layer."""
    parts = [fn(w[i]) for i in range(w.shape[0])]
    return {k: torch.stack([p[k] for p in parts]) for k in parts[0]}


def quantize_stacked_layers(
    layers: dict, bits: int = 8, min_size: int = 1 << 20, scheme: str = "absmax",
    only: Optional[Sequence[str]] = None,
) -> dict:
    """Quantize every large float leaf of a stacked-layer tree (stacked
    (L, in, out) matrices of at least ``min_size`` elements), leaving norms,
    biases and small leaves as they are (``quantize.py:262-300``).

    ``scheme``: 'absmax' (int8 / int4 by ``bits``), 'nf4' or 'w8a8'.
    ``only``: quantize just the leaves whose 'a/b/c' path contains one of
    these substrings."""

    def q(leaf):
        if (
            isinstance(leaf, torch.Tensor)
            and leaf.is_floating_point()
            and leaf.dim() >= 3
            and leaf.numel() >= min_size
        ):
            if scheme == "nf4":
                return _per_layer(quantize_array_nf4, leaf)
            if scheme == "w8a8":
                return _per_layer(quantize_array_w8a8, leaf)
            return _per_layer(lambda w: quantize_array(w, bits), leaf)
        return leaf

    def walk(v, path):
        if isinstance(v, dict):
            return {k: walk(x, f"{path}/{k}") for k, x in v.items()}
        if only is not None and not any(s in path for s in only):
            return v
        return q(v)

    return {name: walk(v, name) for name, v in layers.items()}


def dequant_layer(lp: dict, dtype: torch.dtype = torch.bfloat16) -> dict:
    """One layer's slice: weight-only leaves become dense ``dtype`` weights,
    packed int4 becomes W8A8 codes with the same scales (``quantize.py:
    312-337``), W8A8 leaves pass through."""

    def walk(v):
        if is_quantized(v):
            if _Q4 in v:
                return {_Q8A: _unpack_i4_codes(v[_Q4]), "scale": v["scale"]}
            return dequantize_array(v, dtype)
        if isinstance(v, dict):
            return {k: walk(x) for k, x in v.items()}
        return v

    return {k: walk(v) for k, v in lp.items()}
