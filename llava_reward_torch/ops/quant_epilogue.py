"""Quantizing epilogues of the W8A8 path: int8 codes + per-row amax.

Counterpart of ``llava_reward_tpu/ops/quant_epilogue.py``. Four TPU
kernels feed the int8 GEMM (``ops/int8_matmul.py``): three on the
``--load_in_8bit`` decoder, the LayerNorm one on a W8A8 CLIP tower; each is a CUDA kernel written by hand for Hopper
in ``llava_reward_torch/csrc/quant_epilogue.cu``, with beside it here:

- a plain PyTorch version (``*_plain``), which repeats the TPU kernel's
  arithmetic: fp32 internals, the bf16 rounding points of bf16 input,
  ``amax := 1`` for an all-zero row, codes ``round(y * (127 / amax))``
  (round half to even), and the amax itself as the row scale (the GEMM
  divides it by 127). A wrapper takes it only for a tensor that lies on
  the CPU; for a CUDA tensor it launches the kernel or raises;
- a launch counter, ``LAUNCHES[name]``, raised by one where the kernel is
  launched and nowhere else (``PLAIN_CALLS[name]`` counts the plain
  version's calls).

==================  ==========================================  =======================
name                TPU kernel replaced                         codes of
==================  ==========================================  =======================
``rms_quant``       ``_rms_quant_kernel`` (B4), :46-66           Phi-3 RMSNorm(x)
``silu_mul_quant``  ``_silu_mul_quant_kernel`` (B5), :126-140    silu(gate) * up
``row_quant``       ``_row_quant_kernel`` (B6), :183-188         x
``ln_quant``        ``_ln_quant_kernel`` (B9), :32-43            LayerNorm(x), fp32
==================  ==========================================  =======================

B9 quantizes the fp32 LayerNorm output (no bf16 rounding in between, unlike
B4). It fires in ``models/clip_vit.py`` on W8A8 CLIP weights, which a
caller builds with ``quantize_stacked_layers(clip["layers"], scheme="w8a8")``.

B5 and B6 have two more modes for a row split over tensor-parallel ranks
(``parallel/tensor.py``: each rank holds some of the row's columns), so that
every rank's codes are those of the whole row, as the JAX package takes them
on one device: ``row_absmax`` / ``silu_mul_absmax`` give the raw absmax of
this rank's columns (no ``amax := 1``), which the ranks MAX-reduce; then
``row_quant(x, amax)`` / ``silu_mul_quant(gate_up, amax)`` write the codes
on that given amax in one pass, with no row reduction. Max and the
per-element rounding are exact, so the codes equal the whole row's bit for
bit. These four launches are counted apart, in ``TP_LAUNCHES`` (and
``TP_PLAIN_CALLS``); ``SHAPES`` counts B5's and B6's launches by mode and
row width.

B4 and B9 are one streaming kernel (``norm_quant_kernel``): tiles of R rows
come into a ring of S stages in shared memory by one bulk copy each, one
warp per row. ``tile_plan`` chooses R and S per width and dtype; the launch
refuses a width the kernel does not take (not a multiple of 16, or above
``NQ_MAX_WIDTH``) with ``ValueError`` before anything runs.

B6 takes one of two forms (``row_plan``): the same streaming kernel with
no weight (codes stored from registers) where the width is a multiple of 16
up to ``ROW_WARP_MAX``, and a block a row for every other multiple of 8. A
width neither takes raises ``ValueError`` before any launch.
"""

from __future__ import annotations

import functools
from typing import Dict, NamedTuple, Optional, Tuple

import torch

from ..core.device import on_card
from ..utils.profiling import spanned

_NAMES = ("rms_quant", "silu_mul_quant", "row_quant", "ln_quant")
LAUNCHES: Dict[str, int] = {n: 0 for n in _NAMES}
PLAIN_CALLS: Dict[str, int] = {n: 0 for n in _NAMES}
# B5 / B6 on a row split over tp ranks: the raw absmax of this rank's columns,
# and the codes on a given (tp-global) amax
TP_NAMES = ("row_absmax", "row_quant_given", "silu_mul_absmax", "silu_mul_quant_given")
TP_LAUNCHES: Dict[str, int] = {n: 0 for n in TP_NAMES}
TP_PLAIN_CALLS: Dict[str, int] = {n: 0 for n in TP_NAMES}
# B5 / B6 launches by mode and row width, "<name> <width>" (a tp rank's share)
SHAPES: Dict[str, int] = {}

Codes = Tuple[torch.Tensor, torch.Tensor]  # int8 (..., n), f32 amax (..., 1)


def reset_counters() -> None:
    for d in (LAUNCHES, PLAIN_CALLS, TP_LAUNCHES, TP_PLAIN_CALLS):
        for k in d:
            d[k] = 0
    SHAPES.clear()


def _count(counts: Dict[str, int], name: str, width: int) -> None:
    counts[name] += 1
    key = f"{name} {width}"
    SHAPES[key] = SHAPES.get(key, 0) + 1


def supported(x: torch.Tensor) -> bool:
    """``quant_epilogue.py:225-231``: a 128-multiple feature axis and
    f32/bf16 input."""
    return x.dim() >= 2 and x.shape[-1] % 128 == 0 and x.dtype in (torch.float32, torch.bfloat16)


# --------------------------------------------------------------- plain versions


def _bf16_round(y: torch.Tensor) -> torch.Tensor:
    return y.to(torch.bfloat16).float()


def ieee_div(a, b: torch.Tensor) -> torch.Tensor:
    """``a / b`` rounded once, also for a Python-number operand: PyTorch
    computes ``number / tensor`` as ``reciprocal(tensor) * number``, and on
    the card ``tensor / number`` as ``tensor * (1 / number)``."""
    if not isinstance(a, torch.Tensor):
        a = torch.full_like(b, a)
    elif not isinstance(b, torch.Tensor):
        b = torch.full_like(a, b)
    return torch.div(a, b)


def row_codes(y: torch.Tensor, amax: Optional[torch.Tensor] = None) -> Codes:
    """fp32 (..., n) -> (int8 codes, amax): the shared tail of every kernel;
    on the row's own absmax, or on a given one (a tp-global amax)."""
    if amax is None:
        amax = y.abs().amax(dim=-1, keepdim=True)
    amax = torch.where(amax > 0, amax, torch.ones_like(amax))
    return torch.round(y * ieee_div(127.0, amax)).to(torch.int8), amax


def rms_quant_plain(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-5) -> Codes:
    """Plain version of B4: normalise in fp32 with ``1/sqrt(var + eps)``;
    for bf16 input round to bf16, multiply by the weight in fp32, round to
    bf16 again (Phi-3's cast order, ``quant_epilogue.py:55-62``)."""
    PLAIN_CALLS["rms_quant"] += 1
    xf = x.float()
    var = ieee_div(torch.sum(xf * xf, dim=-1, keepdim=True), float(x.shape[-1]))
    xn = xf * torch.reciprocal(torch.sqrt(var + eps))
    w = weight.float()
    if x.dtype == torch.bfloat16:
        y = _bf16_round(w * _bf16_round(xn))
    else:
        y = w * xn
    return row_codes(y)


def ln_quant_plain(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                   eps: float = 1e-5) -> Codes:
    """Plain version of B9: LayerNorm in fp32 (mean, centred variance,
    ``xc * 1/sqrt(var + eps) * w + b``) quantized without a rounding to the
    input dtype in between (``quant_epilogue.py:32-43, 112-118``)."""
    PLAIN_CALLS["ln_quant"] += 1
    xf = x.float()
    n = float(x.shape[-1])
    xc = xf - ieee_div(torch.sum(xf, dim=-1, keepdim=True), n)
    var = ieee_div(torch.sum(xc * xc, dim=-1, keepdim=True), n)
    y = xc * torch.reciprocal(torch.sqrt(var + eps))
    return row_codes(y * weight.float() + bias.float())


def _silu_mul(gate_up: torch.Tensor) -> torch.Tensor:
    I = gate_up.shape[-1] // 2
    g = gate_up[..., :I].float()
    u = gate_up[..., I:].float()
    y = g * torch.sigmoid(g) * u
    return _bf16_round(y) if gate_up.dtype == torch.bfloat16 else y


def _absmax(y: torch.Tensor) -> torch.Tensor:
    return y.abs().amax(dim=-1, keepdim=True)


def silu_mul_quant_plain(gate_up: torch.Tensor, amax: Optional[torch.Tensor] = None) -> Codes:
    """Plain version of B5: gate in the first I columns of (..., 2I);
    ``g * sigmoid(g) * u`` in fp32, rounded to bf16 for bf16 input; codes on
    the row's amax, or on the given ``amax`` (..., 1)."""
    (PLAIN_CALLS if amax is None else TP_PLAIN_CALLS)[
        "silu_mul_quant" if amax is None else "silu_mul_quant_given"] += 1
    return row_codes(_silu_mul(gate_up), amax)


def silu_mul_absmax_plain(gate_up: torch.Tensor) -> torch.Tensor:
    """Plain version of B5's absmax-only mode: the raw row absmax of
    silu(gate) * up (..., 1), fp32."""
    TP_PLAIN_CALLS["silu_mul_absmax"] += 1
    return _absmax(_silu_mul(gate_up))


def row_quant_plain(x: torch.Tensor, amax: Optional[torch.Tensor] = None) -> Codes:
    """Plain version of B6: per-row absmax and round; or the codes on the
    given ``amax`` (..., 1)."""
    (PLAIN_CALLS if amax is None else TP_PLAIN_CALLS)[
        "row_quant" if amax is None else "row_quant_given"] += 1
    return row_codes(x.float(), amax)


def row_absmax_plain(x: torch.Tensor) -> torch.Tensor:
    """Plain version of B6's absmax-only mode: the raw row absmax (..., 1)."""
    TP_PLAIN_CALLS["row_absmax"] += 1
    return _absmax(x.float())


# --------------------------------------------------------------- B4 / B9 tile plan

# The kernel's instantiations (csrc/quant_epilogue.cu, LRT_NQ): a lane holds
# at most this many 8-element chunks of its row in registers, so the widest
# row is 32 lanes x 8 x 20 = 5120 (LLaVA-NeXT-13B's hidden size).
NQ_CHUNKS_PER_LANE = (1, 2, 4, 8, 12, 14, 16, 20)
NQ_MAX_WIDTH = 32 * 8 * NQ_CHUNKS_PER_LANE[-1]
# consumer warps a block, one per row of a tile (csrc: nq_rows_max): 7 up to
# 8 chunks a lane (H <= 2048), 4 beyond
NQ_ROWS_MAX, NQ_ROWS_MAX_WIDE = 7, 4
NQ_STAGE_BYTES = 32 * 1024  # the input bytes of one tile, at most (one row above)
NQ_STAGES = 2  # deeper rings ran slower on an H100 (tools/epilogue_timing.py --sweep)
NQ_HEAD = 128  # the ring's barriers


class TilePlan(NamedTuple):
    rows: int  # R: rows of a tile, one consumer warp each
    stages: int  # S: tiles in the ring
    smem: int  # dynamic shared memory of a block, bytes


@functools.lru_cache(maxsize=None)
def tile_plan(H: int, x_bytes: int, ln: bool, M: int) -> TilePlan:
    """R and S of the streaming B4 (``ln=False``) / B9 kernel for M rows of
    width H and ``x_bytes`` per input element: as many rows a tile as the
    block has consumer warps, within 32 KiB of input, in a ring of two
    stages. The shared memory is laid out as the kernel lays it
    (csrc/quant_epilogue.cu:nq_smem): the barriers, S stages of R input rows,
    two staging tiles of R rows of codes, the fp32 weight (and bias). Raises
    ValueError for a width the bulk copies or the registers do not take."""
    if H <= 0 or H % 16:
        raise ValueError(f"the row width {H} is not a multiple of 16: the codes of a tile "
                         "leave by one bulk copy, whose size must be a multiple of 16 bytes")
    if H > NQ_MAX_WIDTH:
        raise ValueError(f"the row width {H} is wider than the {NQ_MAX_WIDTH} that the "
                         "kernel holds in registers")
    row = H * x_bytes
    rows_max = NQ_ROWS_MAX if H <= 32 * 8 * 8 else NQ_ROWS_MAX_WIDE
    R = max(1, min(rows_max, NQ_STAGE_BYTES // row, M))
    smem = NQ_HEAD + NQ_STAGES * R * row + 2 * R * H + 4 * H * (2 if ln else 1)
    return TilePlan(R, NQ_STAGES, smem)


# --------------------------------------------------------------- B6's plan

ROW_MODES = ("whole", "absmax", "given")  # codes + amax; the raw absmax; codes on a given amax
# the warp form's whole-lane instantiations that B6 alone has (csrc:
# LRT_RQ_FULL): a tp-2 rank's o_proj widths 1536, 1792 and 2560
ROW_FULL_CHUNKS = (6, 7, 10)
# the warp form's widest row: on an H100 the warp form read faster than the
# block form at every main-path width up to 3584 (a third at 1024, a fifth at
# 3584 on a LoRA step's rows), the block form as fast or faster from 4096 on
# (PERF.md)
ROW_WARP_MAX = 3584
# the block form keeps a whole row in shared memory, as it came, up to this
# size (two blocks an SM); a larger one is read again for its codes
ROW_KEEP_BYTES = 112 * 1024


class RowPlan(NamedTuple):
    form: int  # 0: the warp form (norm_quant_kernel, OP_ROW); 1: the block form
    nv: int  # warp form: 8-element chunks a lane holds (the instantiation); block form 0
    rows: int  # warp form: R rows a tile, one consumer warp each; block form 1
    stages: int  # warp form: S tiles in the ring; block form 1
    keep: int  # block form, whole-row mode: 1 keeps the row in shared memory
    smem: int  # dynamic shared memory of a block, bytes


def _row_chunks(H: int) -> int:
    if H % 256 == 0 and H // 256 in ROW_FULL_CHUNKS:
        return H // 256
    return next(n for n in NQ_CHUNKS_PER_LANE if 32 * n * 8 >= H)


@functools.lru_cache(maxsize=None)
def row_plan(H: int, x_bytes: int, mode: str) -> RowPlan:
    """B6's form for rows of width H, ``x_bytes`` an input element, in
    ``mode`` (``ROW_MODES``). A multiple of 16 up to ``ROW_WARP_MAX``: the
    warp form, B4's ring of R-row tiles (``tile_plan``'s R and S) with no
    weight and no staged codes. Any other multiple of 8: the block form, a
    block a row, whose whole-row mode keeps the row in shared memory in its
    input dtype up to ``ROW_KEEP_BYTES`` (a larger row is read twice).
    Raises ValueError for a width that is not a multiple of 8."""
    if mode not in ROW_MODES:
        raise ValueError(f"row_quant: mode {mode!r} is not one of {ROW_MODES}")
    if H <= 0 or H % 8:
        raise ValueError(f"row_quant: the row width {H} is not a multiple of 8: the kernels "
                         "read and write a row in whole 8-element chunks")
    if H % 16 == 0 and H <= ROW_WARP_MAX:
        R = tile_plan(H, x_bytes, False, NQ_ROWS_MAX).rows  # B4's tiles
        return RowPlan(0, _row_chunks(H), R, NQ_STAGES, 0, NQ_HEAD + NQ_STAGES * R * H * x_bytes)
    keep = int(mode == "whole" and H * x_bytes <= ROW_KEEP_BYTES)
    return RowPlan(1, 0, 1, 1, keep, keep * H * x_bytes)


@functools.lru_cache(maxsize=None)
def _row_launch(device: int, H: int, is_bf16: bool, mode: str) -> Tuple[RowPlan, int]:
    """The plan and, for the warp form, the blocks of it that fit the card at
    once, asked once a plan and device (the query also sets the kernel's
    shared-memory attributes); the block form launches a block a row."""
    from . import cuda_lib

    plan = row_plan(H, 2 if is_bf16 else 4, mode)
    if plan.form == 1:
        return plan, 0
    blocks = cuda_lib.load().lrt_row_quant_blocks(int(is_bf16), plan.nv, H, plan.rows,
                                                  plan.stages)
    if blocks < 1:
        raise RuntimeError(f"row_quant: {plan} does not launch (CUDA error {-blocks})")
    return plan, blocks


# --------------------------------------------------------------- kernel launches


_INFERENCE_ONLY = (
    "the quantizing epilogues are inference-only: under LoRA the use_rq gate in "
    "models/phi3.decoder_layer (use_ln_quant in models/clip_vit) is off, and a "
    "differentiable W8A8 matmul goes through utils/quantize.int8_linear (_Int8LinearCore)"
)


def _rows(name: str, x: torch.Tensor, n: int) -> int:
    """M, the rows of n that the kernels read from x's pointer, once x is
    checked as they read it."""
    from . import cuda_lib

    cuda_lib.refuse_grad(name, x, route=_INFERENCE_ONLY)
    if not x.is_cuda or x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"{name}: expects f32/bf16 CUDA tensors, got {x.dtype} on {x.device}")
    if n % 8:
        raise ValueError(f"{name}: the row width {n} is not a multiple of 8")
    if not x.is_contiguous():
        # never copied silently: the caller's producer decides the layout
        raise ValueError(f"{name}: the (M, {x.shape[-1]}) view of x is not contiguous")
    if x.data_ptr() % 16:
        raise ValueError(f"{name}: x is not 16-byte aligned")
    return x.numel() // x.shape[-1]


def _outputs(x: torch.Tensor, M: int, n: int):
    codes = torch.empty(M, n, dtype=torch.int8, device=x.device)
    amax = torch.empty(M, 1, dtype=torch.float32, device=x.device)
    return codes, amax


def _stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def _norm_weights(name: str, x: torch.Tensor, H: int, **ws: torch.Tensor) -> None:
    """The weight (and bias) are read in their own dtype: (H,), f32 or bf16,
    contiguous, on x's card. Never copied here: a copy would be a launch."""
    if any(t.shape != (H,) for t in ws.values()):
        raise ValueError(f"{name}: {' and '.join(ws)} must be ({H},), got "
                         + " and ".join(str(tuple(t.shape)) for t in ws.values()))
    for k, t in ws.items():
        if t.device != x.device or t.dtype not in (torch.float32, torch.bfloat16) \
                or not t.is_contiguous():
            raise ValueError(f"{name}: {k} must be a contiguous f32/bf16 tensor on "
                             f"{x.device}, got {t.dtype} on {t.device}")


def _launch_rms_quant(x, weight, eps):
    from . import cuda_lib

    H = x.shape[-1]
    cuda_lib.refuse_grad("rms_quant", weight, route=_INFERENCE_ONLY)
    M = _rows("rms_quant", x, H)
    _norm_weights("rms_quant", x, H, weight=weight)
    plan = tile_plan(H, x.element_size(), False, M)
    codes, amax = _outputs(x, M, H)
    err = cuda_lib.load().lrt_rms_quant(
        x.data_ptr(), weight.data_ptr(), codes.data_ptr(), amax.data_ptr(), M, H, float(eps),
        int(x.dtype == torch.bfloat16), int(weight.dtype == torch.bfloat16), plan.rows,
        plan.stages, _stream(),
    )
    cuda_lib.check(err, "lrt_rms_quant")
    LAUNCHES["rms_quant"] += 1
    return codes.view(*x.shape[:-1], H), amax.view(*x.shape[:-1], 1)


def _launch_ln_quant(x, weight, bias, eps):
    from . import cuda_lib

    H = x.shape[-1]
    cuda_lib.refuse_grad("ln_quant", weight, bias, route=_INFERENCE_ONLY)
    M = _rows("ln_quant", x, H)
    _norm_weights("ln_quant", x, H, weight=weight, bias=bias)
    plan = tile_plan(H, x.element_size(), True, M)
    codes, amax = _outputs(x, M, H)
    bf = torch.bfloat16
    err = cuda_lib.load().lrt_ln_quant(
        x.data_ptr(), weight.data_ptr(), bias.data_ptr(), codes.data_ptr(), amax.data_ptr(),
        M, H, float(eps), int(x.dtype == bf), int(weight.dtype == bf), int(bias.dtype == bf),
        plan.rows, plan.stages, _stream(),
    )
    cuda_lib.check(err, "lrt_ln_quant")
    LAUNCHES["ln_quant"] += 1
    return codes.view(*x.shape[:-1], H), amax.view(*x.shape[:-1], 1)


def _given(name: str, amax: Optional[torch.Tensor], x: torch.Tensor, M: int):
    """A given amax as the kernels read it: (M,) f32, contiguous, on x's card."""
    if amax is None:
        return None
    if amax.numel() != M or amax.dtype != torch.float32 or amax.device != x.device \
            or not amax.is_contiguous():
        raise ValueError(f"{name}: the given amax must be a contiguous f32 tensor of {M} rows "
                         f"on {x.device}, got {tuple(amax.shape)} {amax.dtype} on {amax.device}")
    return amax


def _launch_silu_mul_quant(gate_up, amax_in=None, codes_out=True):
    """B5; with ``amax_in`` its given-amax mode, with ``codes_out`` False its
    absmax-only mode (-> the raw amax alone)."""
    from . import cuda_lib

    I2 = gate_up.shape[-1]
    I = I2 // 2
    if I2 % 2 or I % 8:
        raise ValueError(f"silu_mul_quant: 2I = {I2} needs I a multiple of 8")
    M = _rows("silu_mul_quant", gate_up, I2)
    amax_in = _given("silu_mul_quant", amax_in, gate_up, M)
    codes, amax = _outputs(gate_up, M, I if codes_out else 0)
    err = cuda_lib.load().lrt_silu_mul_quant(
        gate_up.data_ptr(), codes.data_ptr() if codes_out else None, amax.data_ptr(),
        None if amax_in is None else amax_in.data_ptr(), M, I,
        int(gate_up.dtype == torch.bfloat16), _stream(),
    )
    cuda_lib.check(err, "lrt_silu_mul_quant")
    lead = gate_up.shape[:-1]
    if not codes_out:
        _count(TP_LAUNCHES, "silu_mul_absmax", I)
        return amax.view(*lead, 1)
    if amax_in is None:
        _count(LAUNCHES, "silu_mul_quant", I)
    else:
        _count(TP_LAUNCHES, "silu_mul_quant_given", I)
    return codes.view(*lead, I), amax.view(*lead, 1)


def _launch_row_quant(x, amax_in=None, codes_out=True):
    """B6; its modes as B5's. The plan and grid are cached per width, dtype,
    mode and device, so a call costs the checks, two allocations in their
    final shapes and one launch."""
    from . import cuda_lib

    H = x.shape[-1]
    M = _rows("row_quant", x, H)
    amax_in = _given("row_quant", amax_in, x, M)
    mode = ("whole" if amax_in is None else "given") if codes_out else "absmax"
    bf = x.dtype == torch.bfloat16
    dev = x.get_device()
    plan, blocks = _row_launch(dev, H, bf, mode)
    amax = torch.empty(x.shape[:-1] + (1,), dtype=torch.float32, device=dev)
    codes = torch.empty(x.shape, dtype=torch.int8, device=dev) if codes_out else None
    grid = M if plan.form else min(-(-M // plan.rows), blocks)
    err = cuda_lib.load().lrt_row_quant(
        x.data_ptr(), None if codes is None else codes.data_ptr(), amax.data_ptr(),
        None if amax_in is None else amax_in.data_ptr(), M, H, int(bf), plan.form, plan.nv,
        plan.rows, plan.stages, plan.keep, max(1, grid), torch._C._cuda_getCurrentRawStream(dev),
    )
    cuda_lib.check(err, "lrt_row_quant")
    if not codes_out:
        _count(TP_LAUNCHES, "row_absmax", H)
        return amax
    _count(LAUNCHES if amax_in is None else TP_LAUNCHES,
           "row_quant" if amax_in is None else "row_quant_given", H)
    return codes, amax


# --------------------------------------------------------------- wrappers


@spanned("w8a8")
def rms_quant(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-5) -> Codes:
    """B4 (``quant_epilogue.py:121``): RMSNorm (Phi-3 cast order) + row int8."""
    if not on_card(x):
        return rms_quant_plain(x, weight, eps)
    return _launch_rms_quant(x, weight, eps)


@spanned("w8a8")
def ln_quant(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
             eps: float = 1e-5) -> Codes:
    """B9 (``quant_epilogue.py:112``): LayerNorm (fp32) + row int8."""
    if not on_card(x):
        return ln_quant_plain(x, weight, bias, eps)
    return _launch_ln_quant(x, weight, bias, eps)


@spanned("w8a8")
def silu_mul_quant(gate_up: torch.Tensor, amax: Optional[torch.Tensor] = None) -> Codes:
    """B5 (``quant_epilogue.py:143``): (..., 2I) -> codes (..., I) + amax; on
    a given ``amax`` (..., 1) f32 (a tp-global one) with no row reduction."""
    if not on_card(gate_up):
        return silu_mul_quant_plain(gate_up, amax)
    return _launch_silu_mul_quant(gate_up, amax)


def silu_mul_absmax(gate_up: torch.Tensor) -> torch.Tensor:
    """B5's absmax-only mode: the raw row absmax of silu(gate) * up (..., 1)."""
    if not on_card(gate_up):
        return silu_mul_absmax_plain(gate_up)
    return _launch_silu_mul_quant(gate_up, codes_out=False)


@spanned("w8a8")
def row_quant(x: torch.Tensor, amax: Optional[torch.Tensor] = None) -> Codes:
    """B6 (``quant_epilogue.py:191``): per-row absmax + round, one pass; or
    the codes on a given ``amax`` (..., 1) f32."""
    if not on_card(x):
        return row_quant_plain(x, amax)
    return _launch_row_quant(x, amax)


def row_absmax(x: torch.Tensor) -> torch.Tensor:
    """B6's absmax-only mode: the raw row absmax (..., 1), f32."""
    if not on_card(x):
        return row_absmax_plain(x)
    return _launch_row_quant(x, codes_out=False)
