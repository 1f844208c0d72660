"""Plain float32 building blocks of the references: no kernel, cache or
batching, and TF32 off, so that a float32 product is a float32 product.

``rounding(torch.bfloat16)`` makes the same code a bfloat16 model: every
op's output (products, attention, norms, activations, residual sums) is
rounded to bfloat16, products and softmax still accumulating in float32,
as the card's bf16 kernels do. It measures how far one seed's model moves
under bf16 rounding alone, the yardstick of ``compare.py``.

``control({"bf16": "fp8"})`` (or ``{"w8a8": "int4"}``) computes the layers'
weight products one precision below what the cell states
(``product``): the control that ``compare.py``'s limits have to catch."""

from __future__ import annotations

import contextlib
import io
import math

import numpy as np
import torch

CLIP_MEAN = np.asarray([0.48145466, 0.4578275, 0.40821073], np.float32)
CLIP_STD = np.asarray([0.26862954, 0.26130258, 0.27577711], np.float32)


_LOW = None


@contextlib.contextmanager
def rounding(dtype):
    global _LOW
    old, _LOW = _LOW, dtype
    try:
        yield
    finally:
        _LOW = old


def low(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to the dtype ``rounding`` set, as float32; as it is
    otherwise."""
    return x if _LOW is None else x.to(_LOW).float()


def strict_fp32() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def decode(png: bytes):
    from PIL import Image

    return Image.open(io.BytesIO(png)).convert("RGB")


def f32(t: torch.Tensor) -> torch.Tensor:
    return t.float()


def rms_norm(x, w, eps):
    return low(low(x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps)) * w.float())


def layer_norm(x, w, b, eps):
    mu = x.mean(-1, keepdim=True)
    var = ((x - mu) ** 2).mean(-1, keepdim=True)
    return low((x - mu) * torch.rsqrt(var + eps) * w.float() + b.float())


def rotate_half(x):
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([-x2, x1], dim=-1)


def attention(q, k, v, mask=None, causal=False):
    """q (S, h, d), k / v (S, hk, d) -> (S, h * d); ``mask`` (S, S) bool of
    the pairs allowed. Softmax in float32, one head group at a time."""
    S, h, d = q.shape
    rep = h // k.shape[1]
    out = torch.empty(S, h, d, dtype=q.dtype, device=q.device)
    allowed = mask
    if causal:
        tri = torch.ones(S, S, dtype=torch.bool, device=q.device).tril()
        allowed = tri if allowed is None else allowed & tri
    for i in range(0, h, 4):
        hq = q[:, i:i + 4].transpose(0, 1)
        kv = torch.arange(i, min(i + 4, h), device=q.device) // rep
        hk, hv = k[:, kv].transpose(0, 1), v[:, kv].transpose(0, 1)
        s = hq @ hk.transpose(1, 2) / math.sqrt(d)
        if allowed is not None:
            s = s.masked_fill(~allowed, float("-inf"))
        out[:, i:i + 4] = (torch.softmax(s, dim=-1) @ hv).transpose(0, 1)
    return low(out.reshape(S, h * d))


_CONTROL: dict = {}
QMAX = {"fp8": 448.0, "w8a8": 127.0, "int4": 7.0}


@contextlib.contextmanager
def control(schemes: dict):
    """Within, a product that the cell states in scheme ``s`` ('bf16',
    'w8a8') is computed in ``schemes.get(s, s)``."""
    global _CONTROL
    old, _CONTROL = _CONTROL, dict(schemes)
    try:
        yield
    finally:
        _CONTROL = old


def _codes(t: torch.Tensor, dim: int, scheme: str):
    """Symmetric codes of ``t`` (float32 values) and their scales, one scale
    per slice along ``dim``: int8 / int4 rounded to the nearest step, fp8
    (e4m3) to the nearest representable value."""
    qmax = QMAX[scheme]
    s = t.abs().amax(dim=dim, keepdim=True) / qmax
    s = torch.where(s > 0, s, torch.ones_like(s))
    if scheme == "fp8":
        return (t / s).to(torch.float8_e4m3fn).float(), s
    return torch.clamp(torch.round(t / s), -qmax, qmax), s


def product(x, w, stated: str = "bf16"):
    """x (S, K) float32 @ W (K, N) in the scheme the cell states, or the
    control's (``control``): 'bf16' the plain product (rounded as
    ``rounding`` says); 'w8a8', 'int4' and 'fp8' as a quantized linear
    computes it: the weight coded by output column, the activations by row,
    the codes' product in float32 scaled back."""
    scheme = _CONTROL.get(stated, stated)
    if scheme == "bf16":
        return low(x @ f32(w))
    xq, xs = _codes(x, -1, scheme)
    wq, ws = _codes(f32(w), 0, scheme)
    return low((xq @ wq) * xs * ws)


def skipca_last(head, last, vision, slots, eps):
    """SkipCA at the last position: ``last`` (H,) attends over ``vision`` (m, H),
    zero-padded to ``slots`` rows, then RMSNorm(last + out)."""
    p = head["skipca"]
    H = last.shape[-1]
    if slots > vision.shape[0]:
        vision = torch.cat([vision, vision.new_zeros(slots - vision.shape[0], H)])
    q = low(last @ f32(p["W_q"]["kernel"]))
    k = low(vision @ f32(p["W_k"]["kernel"]))
    v = low(vision @ f32(p["W_v"]["kernel"]))
    probs = low(torch.softmax(k @ q / math.sqrt(H), dim=-1))
    return rms_norm(low(last + low(probs @ v)), p["ca_layernorm"]["weight"], eps)
