"""The W8A8 GEMM: int8 codes x int8 weights -> s32, then the scale epilogue.

Counterpart of ``llava_reward_tpu/ops/int8_matmul.py``. The TPU kernel
``_make_kernel`` (B7, :55-88, via ``w8a8_matmul`` :124-161) quantizes x by
rows, runs an s8 x s8 -> s32 product and folds both scales in an fp32
epilogue. On the TPU, XLA computed that product by default; on the card no
compiler stands in for XLA, so the hand-written CUDA kernel in
``llava_reward_torch/csrc/int8_matmul.cu`` carries every W8A8 matmul of the
port. Two entries:

- ``int8_matmul_pre(codes, amax, wq, wscale, out_dtype)``: pre-quantized
  activations, as the epilogues of ``ops/quant_epilogue.py`` emit them
  (the form behind ``utils/quantize.int8_linear_pre``);
- ``w8a8_matmul(x, wq, wscale, out_dtype)``: the dynamic form, B7's own
  function. It is two launches: B6's row-quantize kernel, then the GEMM.

The epilogue keeps the order of ``_int8_matmul_2d`` / ``int8_linear_pre``:
``f32(acc) * (amax / 127) * wscale[n]``, then one cast. (The Pallas kernel
forms ``amax * (1/127)``, within one output ulp of this.) Integer sums are
exact, so the kernel and its plain version agree bit for bit. The plain
version forms the s32 product in int32 on the CPU and in float64 on the
card, which is exact there because ``|sum| <= K * 127^2 < 2^53``.

The kernel reads the weight K-major: ``wq`` keeps its ``(K, N)`` = (in, out)
shape and values, with strides ``(1, K)`` (its storage is the (N, K)
transpose), as every W8A8 leaf of the port is made
(``utils/quantize.k_major``). The launch refuses any other layout; it never
copies or transposes a weight itself. K and N must be multiples of 16 (the
tensor maps' 16-byte row strides); M is any. ``LAUNCHES["int8_matmul"]``
counts GEMM launches.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from ..core.device import on_card
from ..utils.profiling import spanned
from . import quant_epilogue as qe

LAUNCHES: Dict[str, int] = {"int8_matmul": 0}
PLAIN_CALLS: Dict[str, int] = {"int8_matmul": 0}
# launches by weight shape, "int8_matmul K<K> N<N>" (a tp rank's K / tp or N / tp)
SHAPES: Dict[str, int] = {}


def reset_counters() -> None:
    for d in (LAUNCHES, PLAIN_CALLS):
        for k in d:
            d[k] = 0
    SHAPES.clear()


# --------------------------------------------------------------- plain versions


def _s32_product(codes: torch.Tensor, wq: torch.Tensor) -> torch.Tensor:
    """Exact s8 x s8 -> s32 product as fp32 (the epilogue's first cast)."""
    if codes.is_cuda:
        return torch.matmul(codes.double(), wq.double()).float()
    return torch.matmul(codes.int(), wq.int()).float()


def int8_matmul_pre_plain(
    codes: torch.Tensor,  # (M, K) int8
    amax: torch.Tensor,  # (M, 1) f32 row amax
    wq: torch.Tensor,  # (K, N) int8
    wscale: torch.Tensor,  # (1, N) or (N,) f32
    out_dtype: torch.dtype,
) -> torch.Tensor:
    """Plain version of B7 on pre-quantized rows."""
    PLAIN_CALLS["int8_matmul"] += 1
    y = _s32_product(codes, wq)
    yf = y * qe.ieee_div(amax.reshape(-1, 1).float(), 127.0) * wscale.reshape(1, -1).float()
    return yf.to(out_dtype)


def w8a8_matmul_plain(x, wq, wscale, out_dtype: Optional[torch.dtype] = None, amax=None):
    """Plain version of B7's dynamic form (``_int8_matmul_2d`` semantics)."""
    codes, amax = qe.row_quant_plain(x, amax)
    return int8_matmul_pre_plain(codes, amax, wq, wscale, out_dtype or x.dtype)


# --------------------------------------------------------------- kernel launch


@spanned("w8a8")
def _launch(codes, amax, wq, wscale, out_dtype):
    from . import cuda_lib

    cuda_lib.refuse_grad(
        "int8_matmul", codes, amax, wq, wscale,
        route="a differentiable W8A8 matmul goes through utils/quantize.int8_linear "
        "(_Int8LinearCore)",
    )
    M, K = codes.shape
    N = wq.shape[1]
    if wq.shape[0] != K or amax.numel() != M or wscale.numel() != N:
        raise ValueError(
            f"int8_matmul: shapes codes {tuple(codes.shape)} amax {tuple(amax.shape)} "
            f"wq {tuple(wq.shape)} wscale {tuple(wscale.shape)}"
        )
    if K % 16 or N % 16:
        raise ValueError(f"int8_matmul: K={K} and N={N} must be multiples of 16")
    if out_dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"int8_matmul: out_dtype {out_dtype} is not bf16 or f32")
    for name, t, dt in (("codes", codes, torch.int8), ("wq", wq, torch.int8),
                        ("amax", amax, torch.float32), ("wscale", wscale, torch.float32)):
        if not t.is_cuda or t.dtype != dt:
            raise ValueError(f"int8_matmul: {name} must be a {dt} CUDA tensor, "
                             f"got {t.dtype} on {t.device}")
        if name != "wq" and not t.is_contiguous():
            raise ValueError(f"int8_matmul: {name} must be contiguous")
    if wq.stride() != (1, K):
        raise ValueError(
            f"int8_matmul: wq must be K-major, strides (1, {K}), got {wq.stride()}; make the "
            "W8A8 leaf with utils/quantize.k_major"
        )
    if codes.data_ptr() % 16 or wq.data_ptr() % 16:
        raise ValueError("int8_matmul: codes and wq must be 16-byte aligned")
    out = torch.empty(M, N, dtype=out_dtype, device=codes.device)
    err = cuda_lib.load().lrt_int8_matmul(
        codes.data_ptr(), wq.data_ptr(), amax.data_ptr(), wscale.data_ptr(), out.data_ptr(),
        M, N, K, int(out_dtype == torch.bfloat16), torch.cuda.current_stream().cuda_stream,
    )
    cuda_lib.check(err, "lrt_int8_matmul")
    LAUNCHES["int8_matmul"] += 1
    key = f"int8_matmul K{K} N{N}"
    SHAPES[key] = SHAPES.get(key, 0) + 1
    return out


# --------------------------------------------------------------- wrappers


def int8_matmul_pre(codes, amax, wq, wscale, out_dtype: torch.dtype = torch.bfloat16):
    """B7 on pre-quantized rows: (M, K) int8 codes + (M, 1) amax ->
    (M, N) ``out_dtype``."""
    if not on_card(codes):
        return int8_matmul_pre_plain(codes, amax, wq, wscale, out_dtype)
    return _launch(codes, amax, wq, wscale, out_dtype)


def w8a8_matmul(x, wq, wscale, out_dtype: Optional[torch.dtype] = None, amax=None):
    """B7's dynamic form (``int8_matmul.py:124``): x (M, K) float ->
    (M, N) ``out_dtype`` (default x's dtype); B6 then the GEMM on the card.
    With ``amax`` (M, 1) f32, x's codes are taken on it (B6's given-amax
    mode): a row-split projection's tp-global amax, so that this rank's
    K-block of codes is that of the whole row."""
    out_dtype = out_dtype or x.dtype
    if not on_card(x):
        return w8a8_matmul_plain(x, wq, wscale, out_dtype, amax)
    codes, amax = qe.row_quant(x, amax)
    return _launch(codes, amax, wq, wscale, out_dtype)
