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
  activations per row; ``ops/int8_matmul.py`` holds that GEMM. The codes
  keep the JAX package's shape and values, but their storage is K-major:
  strides (1, in) per layer (``k_major``), the layout the card's GEMM reads.
  Every place that makes a W8A8 leaf goes through ``k_major`` (or, for a
  concatenation, ``cat_out``).

Under tensor parallelism (``parallel/tensor.py``) each rank keeps its block
of a split quantized leaf (``tp_block``): a column-split projection its out
columns (each fused part's own slice, ``slice_parts``), a row-split one its
in rows (packed rows for the 4-bit schemes, and NF4's scale blocks with
them), every W8A8 block K-major again. The JAX package keeps these leaves
whole on every tp rank; the values a rank computes with are the same.

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
from ..ops.linear import mm
from ..ops.quant_epilogue import ieee_div

_Q8 = "qvalues_i8"
_Q4 = "qvalues_i4"  # two int4 packed per byte along the 'in' axis
_QNF4 = "qvalues_nf4"  # two nf4 codes packed per byte along the 'in' axis
W8A8_KEY = "qvalues_w8a8"  # int8 weights run as int8 (dynamic per-row act quant)

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


def k_major(w: torch.Tensor) -> torch.Tensor:
    """W8A8 codes (..., in, out) with their shape and values and K-major
    storage: strides (1, in) on the last two axes (the (out, in) transpose is
    contiguous). wgmma reads int8 operands K-major only and TMA cannot
    transpose bytes, so this is the one layout ``ops/int8_matmul.py`` takes;
    a ``.to(device)`` keeps it. Codes already K-major come back as they are."""
    return w.mT.contiguous().mT


def cat_out(parts: Sequence[Any]) -> Any:
    """Leaves concatenated on the out axis (fused projections): dense kernels,
    biases and quantized leaf dicts alike; W8A8 codes are concatenated on
    their transposes, so they stay K-major."""
    if isinstance(parts[0], dict):
        return {k: (torch.cat([p[k].mT for p in parts], dim=-2).mT if k == W8A8_KEY
                    else cat_out([p[k] for p in parts])) for k in parts[0]}
    return torch.cat(list(parts), dim=-1)


def quantize_array_w8a8(w) -> QDict:
    """(..., in, out) float -> {'qvalues_w8a8', 'scale'}: symmetric int8 with
    per-(leading, out) scales, the codes K-major (``k_major``); the weights
    stay int8 at run time."""
    q, scale = _absmax_codes(w, 127.0)
    return {W8A8_KEY: k_major(q), "scale": scale}


def is_w8a8(leaf: Any) -> bool:
    return isinstance(leaf, dict) and W8A8_KEY in leaf


def _int8_matmul_2d(x2, w, scale, plain: bool = False, amax=None) -> torch.Tensor:
    """(M, in) x int8 (in, out): per-row absmax codes, s8 x s8 -> s32, then
    ``f32(y) * (amax / 127) * scale`` cast to x's dtype
    (``quantize.py:155-181``). The GEMM's kernel on the card, or with
    ``plain`` its plain version; its plain version on the CPU. With ``amax``
    (M, 1) the codes are taken on it (a row-split block's tp-global amax)."""
    return (w8a8_matmul_plain if plain else w8a8_matmul)(x2, w, scale, x2.dtype, amax)


class _Int8LinearCore(torch.autograd.Function):
    """``_int8_linear_core`` (``quantize.py:184-215``): straight-through
    with respect to the activation quantization; the int8 weights get no
    gradient (a frozen W8A8 base under LoRA). On a row-split tp block
    (``amax`` given) the same rule gives dx for this rank's input columns."""

    @staticmethod
    def forward(ctx, x2, w, scale, plain, amax=None, out_dtype=None):
        ctx.save_for_backward(w, scale)
        ctx.x_dtype = x2.dtype
        if out_dtype is None:
            return _int8_matmul_2d(x2, w, scale, plain, amax)
        gemm = w8a8_matmul_plain if plain else w8a8_matmul
        return gemm(x2, w, scale, out_dtype, amax)

    @staticmethod
    def backward(ctx, dy):
        # dx = (dy * scale) @ w^T (``quantize.py:196-213``): bf16 operands (the
        # int8 codes are exact in bf16) and an fp32 result, rounded once to
        # dy's dtype. On the card one tensor-core GEMM with fp32 output; the
        # CPU has no bf16 -> fp32 mm, and the fp32 product of the same bf16
        # values is that result
        w, scale = ctx.saved_tensors
        dys = (dy.float() * scale.reshape(1, -1)).to(torch.bfloat16)
        wt = w.t().to(torch.bfloat16)
        if dys.is_cuda:
            dx = torch.mm(dys, wt, out_dtype=torch.float32)
        else:
            dx = torch.mm(dys.float(), wt.float())
        return dx.to(ctx.x_dtype), None, None, None, None, None


def int8_linear(x: torch.Tensor, qd: QDict, plain: bool = False,
                amax: Optional[torch.Tensor] = None,
                out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """x (..., in) @ W8A8 weight (in, out); differentiable in x. ``amax``
    (..., 1): the rows' amax to take x's codes on (default: their own);
    ``out_dtype``: the output's (default x's; dx is in x's)."""
    lead = x.shape[:-1]
    y = _Int8LinearCore.apply(x.reshape(-1, x.shape[-1]), qd[W8A8_KEY], qd["scale"], plain,
                              None if amax is None else amax.reshape(-1, 1), out_dtype)
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
    y = fn(codes.reshape(-1, codes.shape[-1]), rowscale.reshape(-1, 1), qd[W8A8_KEY],
           qd["scale"], dtype)
    return y.reshape(*lead, -1)


def qmatmul(x: torch.Tensor, w, plain: bool = False) -> torch.Tensor:
    """The int8 path for a W8A8 leaf, a plain matmul otherwise (weight-only
    schemes were already dequantized by ``dequant_layer``)."""
    if is_w8a8(w):
        return int8_linear(x, w, plain)
    return mm(x, w)


# ------------------------------------------------------------ tp blocks


def slice_parts(t: torch.Tensor, parts: Sequence[int], size: int, rank: int,
                dim: int = -1) -> torch.Tensor:
    """Rank ``rank``'s block along ``dim`` of a fused axis of ``parts``:
    every part's own slice of ``1 / size``, in order."""
    blocks = [p.narrow(dim, rank * (p.shape[dim] // size), p.shape[dim] // size)
              for p in t.split(list(parts), dim)]
    return blocks[0] if len(blocks) == 1 else torch.cat(blocks, dim)


def _owned_k_major(w: torch.Tensor) -> torch.Tensor:
    """A K-major copy of ``w`` in storage of its own (a block never keeps the
    whole leaf's storage alive)."""
    return w.mT.clone(memory_format=torch.contiguous_format).mT


def logical_shape(qd: QDict) -> tuple:
    """The (..., in, out) shape of the float kernel a quantized leaf stands
    for (NF4 and int4 codes hold in / 2 packed rows)."""
    c = next(v for k, v in qd.items() if k != "scale")
    return (*c.shape[:-2], c.shape[-2] * (2 if _QNF4 in qd or _Q4 in qd else 1), c.shape[-1])


def tp_block_dims(qd: QDict, rows: bool) -> Dict[str, Optional[int]]:
    """The axis (from the end) along which each entry of a quantized leaf is
    split under tp, None for an entry kept whole: the codes on 'in' (rows)
    or 'out'; the scale on 'out' when column-split, on NF4's blocks when
    row-split, whole otherwise (one per out column)."""
    return {k: (-2 if rows else -1) if k != "scale" or not rows or _QNF4 in qd else None
            for k in qd}


def tp_block(qd: QDict, rows: bool, parts: Sequence[int], size: int, rank: int) -> QDict:
    """Rank ``rank``'s block (of ``size`` tp ranks) of a quantized leaf
    (..., in, out), in storage of its own:

    - column-split (``rows`` False): the out columns of codes and scale,
      each fused part's own slice (``parts``: their full widths, in order);
    - row-split: the codes' in rows (``in / (2 size)`` packed rows for NF4 and
      int4), NF4's scale blocks (``nb / size``), the per-column scale whole.

    W8A8 codes come back K-major (strides (1, in) per layer)."""
    out = {}
    for k, d in tp_block_dims(qd, rows).items():
        v = qd[k]
        if d is None:
            out[k] = v
            continue
        if rows:
            n = v.shape[d] // size
            b = v.narrow(d, rank * n, n)
        else:
            b = slice_parts(v, parts, size, rank, d)
        out[k] = _owned_k_major(b) if k == W8A8_KEY else b.clone(
            memory_format=torch.contiguous_format)
    return out


def _per_layer(fn: Callable[[torch.Tensor], QDict], w: torch.Tensor) -> QDict:
    """``fn`` one leading slice at a time (every scale is per slice), which
    bounds the fp32 working set to one layer. Each slice is written into the
    stacked leaf as it is made, in the slice's own layout: W8A8 codes (L, in,
    out) land in (L, out, in) storage, K-major per layer, with no second
    whole copy."""
    out: QDict = {}
    for i in range(w.shape[0]):
        for k, v in fn(w[i]).items():
            if k not in out:
                if k == W8A8_KEY:
                    out[k] = torch.empty((w.shape[0], *v.mT.shape), dtype=v.dtype,
                                         device=v.device).mT
                else:
                    out[k] = torch.empty((w.shape[0], *v.shape), dtype=v.dtype, device=v.device)
            out[k][i] = v
    return out


def quantize_stacked_layers(
    layers: dict, bits: int = 8, min_size: int = 1 << 20, scheme: str = "absmax",
    only: Optional[Sequence[str]] = None, device=None, dtype: Optional[torch.dtype] = None,
) -> dict:
    """Quantize every large float leaf of a stacked-layer tree (stacked
    (L, in, out) matrices of at least ``min_size`` elements), leaving norms,
    biases and small leaves as they are (``quantize.py:262-300``).

    ``scheme``: 'absmax' (int8 / int4 by ``bits``), 'nf4' or 'w8a8'.
    ``only``: quantize just the leaves whose 'a/b/c' path contains one of
    these substrings. ``device`` / ``dtype``: where and in what dtype the
    leaves go, a quantized leaf one layer's slice at a time before it is
    quantized (a host tree onto the card: the whole float stack never sits
    there beside its codes)."""

    def move(t):
        return t.to(device=device, dtype=dtype if t.is_floating_point() else None)

    def q(leaf):
        if (
            isinstance(leaf, torch.Tensor)
            and leaf.is_floating_point()
            and leaf.dim() >= 3
            and leaf.numel() >= min_size
        ):
            fn = {"nf4": quantize_array_nf4, "w8a8": quantize_array_w8a8}.get(
                scheme, lambda w: quantize_array(w, bits))
            return _per_layer(lambda w: fn(move(w)), leaf)
        return move(leaf) if isinstance(leaf, torch.Tensor) else leaf

    def walk(v, path):
        if isinstance(v, dict):
            return {k: walk(x, f"{path}/{k}") for k, x in v.items()}
        if only is not None and not any(s in path for s in only):
            return move(v) if isinstance(v, torch.Tensor) else v
        return q(v)

    return {name: walk(v, name) for name, v in layers.items()}


def dequant_layer(lp: dict, dtype: torch.dtype = torch.bfloat16) -> dict:
    """One layer's slice: weight-only leaves become dense ``dtype`` weights,
    packed int4 becomes W8A8 codes with the same scales (``quantize.py:
    312-337``), W8A8 leaves pass through."""

    def walk(v):
        if is_quantized(v):
            if _Q4 in v:
                return {W8A8_KEY: k_major(_unpack_i4_codes(v[_Q4])), "scale": v["scale"]}
            return dequantize_array(v, dtype)
        if isinstance(v, dict):
            return {k: walk(x) for k, x in v.items()}
        return v

    return {k: walk(v) for k, v in lp.items()}
