"""Quantizing epilogues of the W8A8 decoder: int8 codes + per-row amax.

Counterpart of ``llava_reward_tpu/ops/quant_epilogue.py``. Three TPU
kernels feed the int8 GEMM (``ops/int8_matmul.py``) on the
``--load_in_8bit`` path; each is a CUDA kernel written by hand for Hopper
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
==================  ==========================================  =======================

The LayerNorm epilogue (``_ln_quant_kernel``, B9) fires only on W8A8 CLIP
weights, which no entry point makes; it waits for its ROADMAP entry.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from ..core.device import on_card

LAUNCHES: Dict[str, int] = {"rms_quant": 0, "silu_mul_quant": 0, "row_quant": 0}
PLAIN_CALLS: Dict[str, int] = {"rms_quant": 0, "silu_mul_quant": 0, "row_quant": 0}

Codes = Tuple[torch.Tensor, torch.Tensor]  # int8 (..., n), f32 amax (..., 1)


def reset_counters() -> None:
    for d in (LAUNCHES, PLAIN_CALLS):
        for k in d:
            d[k] = 0


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


def row_codes(y: torch.Tensor) -> Codes:
    """fp32 (..., n) -> (int8 codes, amax): the shared tail of every kernel."""
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


def silu_mul_quant_plain(gate_up: torch.Tensor) -> Codes:
    """Plain version of B5: gate in the first I columns of (..., 2I);
    ``g * sigmoid(g) * u`` in fp32, rounded to bf16 for bf16 input."""
    PLAIN_CALLS["silu_mul_quant"] += 1
    I = gate_up.shape[-1] // 2
    g = gate_up[..., :I].float()
    u = gate_up[..., I:].float()
    y = g * torch.sigmoid(g) * u
    if gate_up.dtype == torch.bfloat16:
        y = _bf16_round(y)
    return row_codes(y)


def row_quant_plain(x: torch.Tensor) -> Codes:
    """Plain version of B6: per-row absmax and round."""
    PLAIN_CALLS["row_quant"] += 1
    return row_codes(x.float())


# --------------------------------------------------------------- kernel launches


def _rows(name: str, x: torch.Tensor, n: int) -> Tuple[torch.Tensor, int]:
    """The (M, n) view of x, which the kernels read row by row."""
    if not x.is_cuda or x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"{name}: expects f32/bf16 CUDA tensors, got {x.dtype} on {x.device}")
    if n % 8:
        raise ValueError(f"{name}: the row width {n} is not a multiple of 8")
    if not x.is_contiguous():
        # never copied silently: the caller's producer decides the layout
        raise ValueError(f"{name}: the (M, {x.shape[-1]}) view of x is not contiguous")
    if x.data_ptr() % 16:
        raise ValueError(f"{name}: x is not 16-byte aligned")
    M = x.numel() // x.shape[-1]
    return x.view(M, x.shape[-1]), M


def _outputs(x: torch.Tensor, M: int, n: int):
    codes = torch.empty(M, n, dtype=torch.int8, device=x.device)
    amax = torch.empty(M, 1, dtype=torch.float32, device=x.device)
    return codes, amax


def _stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def _launch_rms_quant(x, weight, eps):
    from . import cuda_lib

    H = x.shape[-1]
    x2, M = _rows("rms_quant", x, H)
    if weight.shape != (H,):
        raise ValueError(f"rms_quant: weight must be ({H},), got {tuple(weight.shape)}")
    w = weight.to(device=x.device, dtype=torch.float32).contiguous()  # exact for bf16
    codes, amax = _outputs(x, M, H)
    err = cuda_lib.load().lrt_rms_quant(
        x2.data_ptr(), w.data_ptr(), codes.data_ptr(), amax.data_ptr(), M, H, float(eps),
        int(x.dtype == torch.bfloat16), _stream(),
    )
    cuda_lib.check(err, "lrt_rms_quant")
    LAUNCHES["rms_quant"] += 1
    return codes.view(*x.shape[:-1], H), amax.view(*x.shape[:-1], 1)


def _launch_silu_mul_quant(gate_up):
    from . import cuda_lib

    I2 = gate_up.shape[-1]
    I = I2 // 2
    if I2 % 2 or I % 8:
        raise ValueError(f"silu_mul_quant: 2I = {I2} needs I a multiple of 8")
    g2, M = _rows("silu_mul_quant", gate_up, I2)
    codes, amax = _outputs(gate_up, M, I)
    err = cuda_lib.load().lrt_silu_mul_quant(
        g2.data_ptr(), codes.data_ptr(), amax.data_ptr(), M, I,
        int(gate_up.dtype == torch.bfloat16), _stream(),
    )
    cuda_lib.check(err, "lrt_silu_mul_quant")
    LAUNCHES["silu_mul_quant"] += 1
    return codes.view(*gate_up.shape[:-1], I), amax.view(*gate_up.shape[:-1], 1)


def _launch_row_quant(x):
    from . import cuda_lib

    H = x.shape[-1]
    x2, M = _rows("row_quant", x, H)
    codes, amax = _outputs(x, M, H)
    err = cuda_lib.load().lrt_row_quant(
        x2.data_ptr(), codes.data_ptr(), amax.data_ptr(), M, H,
        int(x.dtype == torch.bfloat16), _stream(),
    )
    cuda_lib.check(err, "lrt_row_quant")
    LAUNCHES["row_quant"] += 1
    return codes.view(*x.shape[:-1], H), amax.view(*x.shape[:-1], 1)


# --------------------------------------------------------------- wrappers


def rms_quant(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-5) -> Codes:
    """B4 (``quant_epilogue.py:121``): RMSNorm (Phi-3 cast order) + row int8."""
    if not on_card(x):
        return rms_quant_plain(x, weight, eps)
    return _launch_rms_quant(x, weight, eps)


def silu_mul_quant(gate_up: torch.Tensor) -> Codes:
    """B5 (``quant_epilogue.py:143``): (..., 2I) -> codes (..., I) + amax."""
    if not on_card(gate_up):
        return silu_mul_quant_plain(gate_up)
    return _launch_silu_mul_quant(gate_up)


def row_quant(x: torch.Tensor) -> Codes:
    """B6 (``quant_epilogue.py:191``): per-row absmax + round, one pass."""
    if not on_card(x):
        return row_quant_plain(x)
    return _launch_row_quant(x)
