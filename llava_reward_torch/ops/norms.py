"""Normalisation ops with fp32 internals (bf16 in/out).

Counterpart of ``llava_reward_tpu/ops/norms.py``. RMSNorm follows Phi-3's
cast order (``norms.py:13-18``): variance in fp32, rescale by
``1/sqrt(var+eps)``, cast back to the input dtype, THEN multiply by the
weight.

On the card a bf16 input takes one hand-written kernel, the norm mode of
B4 / B9's ``norm_quant_kernel`` (``csrc/quant_epilogue.cu``): a warp a row
in registers, fed by a ring of bulk copies, the normalised row stored by
bulk copy, so the row is read once and written once (4 bytes an element
where the plain passes over fp32 temporaries move 36 for RMSNorm and 64 for
LayerNorm). It rounds where the plain code rounds; only the order of its
fp32 row sums differs. Every other input keeps the plain code: CPU tensors,
fp32, a row the kernel does not take (a width not a multiple of 16, or above
5120 for RMSNorm and 2048 for LayerNorm, which runs in the vision towers
alone; a layout that is not contiguous or 16-byte aligned; an RMSNorm
weight that is not bf16, whose product the plain code promotes; a LayerNorm
weight or bias neither bf16 nor f32, or on another device), and inputs that
take part in autograd.

- ``LAUNCHES[name]``: the kernel's launches in this process;
- the port's counters ``norm.kernel_rows`` and ``norm.plain_rows``
  (``utils/profiling``): rows of card tensors normalised by the kernel and
  by the plain code, while a profiler runs.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional, Tuple

import torch

from ..core.device import on_card
from ..utils import profiling
from .quant_epilogue import (NQ_CHUNKS_PER_LANE, NQ_HEAD, NQ_MAX_WIDTH, NQ_ROWS_MAX, NQ_STAGES,
                             tile_plan)

LAUNCHES = {"rms_norm": 0, "layer_norm": 0}

# the whole-lane instantiation the norm mode alone has (csrc: norm_kernel_t):
# Qwen2.5-VL's vision width, 1280 = 256 x 5
NORM_FULL_CHUNKS = (5,)
# LayerNorm's widest row in the norm mode (csrc: norm_kernel_t's ladder)
LN_MAX_WIDTH = 2048


def reset_counters() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def rms_norm_plain(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """The plain route of ``rms_norm``: fp32 internals, Phi-3's cast order."""
    dtype = x.dtype
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    xf = xf * torch.reciprocal(torch.sqrt(var + eps))
    return weight * xf.to(dtype)


def layer_norm_plain(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                     eps: float = 1e-5) -> torch.Tensor:
    """The plain route of ``layer_norm``: fp32 internals, one rounding to
    x's dtype."""
    dtype = x.dtype
    xf = x.float()
    mean = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.mean((xf - mean) ** 2, dim=-1, keepdim=True)
    xf = (xf - mean) * torch.reciprocal(torch.sqrt(var + eps))
    out = xf * weight.float() + bias.float()
    return out.to(dtype)


class NormPlan(NamedTuple):
    nv: int  # 8-element chunks a lane holds (the instantiation)
    rows: int  # R: rows of a tile, one consumer warp each
    stages: int  # S: tiles in the ring
    smem: int  # dynamic shared memory of a block, bytes


@functools.lru_cache(maxsize=None)
def norm_plan(H: int, ln: bool) -> NormPlan:
    """The norm mode's plan for bf16 rows of width H: B4 / B9's tiles
    (``tile_plan``'s R and S), two staging tiles of the bf16 output, the fp32
    weight (and bias), laid out as csrc/quant_epilogue.cu:norm_plan_kernel
    lays them. Raises ValueError for a width the bulk copies or the registers
    do not take, or a LayerNorm wider than ``LN_MAX_WIDTH``."""
    if ln and H > LN_MAX_WIDTH:
        raise ValueError(f"the row width {H} is wider than the {LN_MAX_WIDTH} of the "
                         "LayerNorm norm mode")
    R = tile_plan(H, 2, ln, NQ_ROWS_MAX).rows
    if H % 256 == 0 and H // 256 in NORM_FULL_CHUNKS:
        nv = H // 256
    else:
        nv = next(n for n in NQ_CHUNKS_PER_LANE if 256 * n >= H)
    smem = NQ_HEAD + NQ_STAGES * R * H * 2 + 2 * R * H * 2 + 4 * H * (2 if ln else 1)
    return NormPlan(nv, R, NQ_STAGES, smem)


@functools.lru_cache(maxsize=None)
def _norm_launch(device: int, H: int, ln: bool) -> Tuple[NormPlan, int]:
    """The plan and the blocks of it that fit the card at once, asked once a
    plan and device (the query also sets the kernel's shared-memory
    attributes)."""
    from . import cuda_lib

    plan = norm_plan(H, ln)
    blocks = cuda_lib.load().lrt_norm_blocks(int(ln), plan.nv, H, plan.rows, plan.stages)
    if blocks < 1:
        raise RuntimeError(f"norm: {plan} does not launch (CUDA error {-blocks})")
    return plan, blocks


def _kernel_takes(x: torch.Tensor, *ws: torch.Tensor) -> bool:
    """Whether the kernel takes x (a card tensor) and its weights as they
    are (``ws``: RMSNorm's weight, or LayerNorm's weight and bias): bf16
    rows of a width it holds, contiguous and 16-byte aligned; weights (H,)
    contiguous on x's card, bf16 (RMSNorm) or bf16 / f32 (LayerNorm, whose
    result is x's dtype either way); no input that takes part in autograd
    (the launch has no backward)."""
    H = x.shape[-1] if x.dim() else 0
    ln = len(ws) == 2
    dtypes = (torch.float32, torch.bfloat16) if ln else (torch.bfloat16,)
    return (x.dtype == torch.bfloat16 and 0 < H <= (LN_MAX_WIDTH if ln else NQ_MAX_WIDTH)
            and H % 16 == 0 and x.is_contiguous() and x.data_ptr() % 16 == 0
            and all(t.shape == (H,) and t.dtype in dtypes
                    and t.device == x.device and t.is_contiguous() for t in ws)
            and not (torch.is_grad_enabled()
                     and any(t.requires_grad for t in (x, *ws))))


def _launch(name: str, x: torch.Tensor, weight: torch.Tensor, bias: Optional[torch.Tensor],
            eps: float) -> torch.Tensor:
    from . import cuda_lib

    H = x.shape[-1]
    M = x.numel() // H
    ln = bias is not None
    dev = x.get_device()
    plan, blocks = _norm_launch(dev, H, ln)
    out = torch.empty(x.shape, dtype=x.dtype, device=x.device)
    bf = torch.bfloat16
    err = cuda_lib.load().lrt_norm(
        x.data_ptr(), weight.data_ptr(), None if bias is None else bias.data_ptr(),
        out.data_ptr(), M, H, float(eps), int(ln), int(weight.dtype == bf),
        int(ln and bias.dtype == bf), plan.nv, plan.rows, plan.stages,
        max(1, min(-(-M // plan.rows), blocks)), torch._C._cuda_getCurrentRawStream(dev),
    )
    cuda_lib.check(err, "lrt_norm")
    LAUNCHES[name] += 1
    return out


def _rows(x: torch.Tensor) -> int:
    return x.numel() // x.shape[-1] if x.dim() and x.shape[-1] else 0


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """RMSNorm in Phi-3's cast order; the result in the promoted dtype of x
    and the weight, as the plain product gives it."""
    if on_card(x):
        if _kernel_takes(x, weight):
            profiling.count("norm.kernel_rows", _rows(x))
            return _launch("rms_norm", x, weight, None, eps)
        profiling.count("norm.plain_rows", _rows(x))
    return rms_norm_plain(x, weight, eps)


def layer_norm(
    x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, eps: float = 1e-5
) -> torch.Tensor:
    """Standard LayerNorm (CLIP tower), fp32 internals."""
    if on_card(x):
        if _kernel_takes(x, weight, bias):
            profiling.count("norm.kernel_rows", _rows(x))
            return _launch("layer_norm", x, weight, bias, eps)
        profiling.count("norm.plain_rows", _rows(x))
    return layer_norm_plain(x, weight, bias, eps)
