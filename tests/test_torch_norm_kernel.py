"""The norm mode of B4 / B9's ``norm_quant_kernel`` (``ops/norms.py``: every
bf16 RMSNorm and LayerNorm on the card) against an emulation of its
arithmetic and against the plain code, on the card; B4's and B9's codes at
their main-path shapes against the same emulation. They need an NVIDIA
Hopper card with ``nvcc`` and skip elsewhere: a CUDA kernel has no CPU mode
(tests/test_torch_norms.py holds the plain code and the routing on the CPU).

The emulation repeats the kernel's fp32 arithmetic op for op with torch's
IEEE elementwise ops, its row sums in the kernel's order (a lane's partial
sums over its chunks, position by position; the eight positions in a fixed
tree; the warp's butterfly), so the kernel must equal it bit for bit, at
every width and row count. Against the plain code only the order of the row
sums differs (torch's reduction, and its mean as a product with 1/H): where
that moves a row's fp32 statistics by an ulp,

- RMSNorm's first rounding, bf16(x / rms), may fall on the other side, one
  bf16 ulp apart; the weight's product carries that to at most two bf16
  ulps of the output (w * ulp(y) is 0.5-2 ulps of w * y, and bf16 x bf16
  products often lie on a tie), so outputs are at most 2 bf16 ulps apart;
- LayerNorm rounds once, at the end: at most one bf16 ulp, except where
  x - mean times the weight cancels the bias, where the fp32 value's few
  ulps of the terms (2^-20 of |(x - mean) / rms * w| + |b|) may be more.

Each case prints its bit-equal share and the largest ulp distance. Run on
a machine with the card (the suite's conftest imports JAX, so leave it out):

    python -m pytest --noconftest -m cuda tests/test_torch_norm_kernel.py -q -s
"""

import pytest
import torch

from llava_reward_torch.ops import norms
from llava_reward_torch.ops import quant_epilogue as qe

pytestmark = pytest.mark.cuda

EPS = 1e-5
# each width's main-path rows: CLIP (17 crops x 640 tokens x 8 rows), the
# Qwen2.5-VL tower (patches of a call), Phi-3 (8 rows x 2944), Qwen2.5-VL's
# decoder (8 x 1792), LLaVA-NeXT (8 x 2976); LayerNorm's widest row, 2048
MAIN_M = {1024: 87040, 1280: 43008, 3072: 23552, 3584: 14336, 5120: 23808}
LN_M = {1024: 87040, 1280: 43008, 2048: 21760}


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.Generator(device="cuda").manual_seed(0)


def _inputs(gen, M, H, wdtype):
    x = torch.randn(M, H, generator=gen, device="cuda").mul_(3).bfloat16()
    if M > 1:
        x[M // 2] = 0  # RMSNorm of a zero row is zero, LayerNorm's the bias
    w = (1 + 0.5 * torch.randn(H, generator=gen, device="cuda")).to(wdtype)
    b = (0.1 * torch.randn(H, generator=gen, device="cuda")).to(wdtype)
    return x, w, b


def _row_sum(t):
    """Row sums of (M, H) fp32 in the kernel's order: chunk c = lane + 32 k of
    8 elements; a lane sums its chunks position by position (k in order, from
    zero), then its 8 positions as ((0+1)+(2+3))+((4+5)+(6+7)), then the
    warp's butterfly over lanes (xor 16, 8, 4, 2, 1)."""
    M, H = t.shape
    nv = norms.norm_plan(H, False).nv
    v = torch.zeros(M, 256 * nv, device=t.device)
    v[:, :H] = t  # absent chunks add nothing: x + 0 = x
    v = v.view(M, nv, 32, 8)
    p = v[:, 0]
    for k in range(1, nv):
        p = p + v[:, k]
    s = ((p[..., 0] + p[..., 1]) + (p[..., 2] + p[..., 3])) + \
        ((p[..., 4] + p[..., 5]) + (p[..., 6] + p[..., 7]))
    lane = torch.arange(32, device=t.device)
    for o in (16, 8, 4, 2, 1):
        s = s + s[:, lane ^ o]
    return s[:, :1]


def _inv(var):  # 1/sqrt(var + eps), each op rounded once (IEEE sqrt and division)
    return torch.reciprocal(torch.sqrt(var + EPS))


def emulate_rms(x, w):
    """The kernel's RMSNorm row: fp32, its sums' order; bf16(x * inv) times
    the weight in fp32 (rounded to bf16 after, for a bf16 weight)."""
    xf = x.float()
    H = float(x.shape[-1])
    r = (xf * _inv(qe.ieee_div(_row_sum(xf * xf), H))).bfloat16().float()
    return w.float() * r


def emulate_ln(x, w, b):
    """The kernel's LayerNorm row in fp32: mean, centred variance in its
    sums' order, ((x - mean) * inv) * w + b, each op rounded once."""
    xf = x.float()
    H = float(x.shape[-1])
    xc = xf - qe.ieee_div(_row_sum(xf), H)
    return xc * _inv(qe.ieee_div(_row_sum(xc * xc), H)) * w.float() + b.float()


def _ordered(t):
    """bf16 values as integers in the order of the values (adjacent floats
    one apart, +0 and -0 equal)."""
    i = t.view(torch.int16).int()
    return torch.where(i < 0, -(i & 0x7FFF), i)


def _report(tag, got, ref, tol):
    """Bit-equal share and largest distance (bf16 ulps, or relative for f32);
    asserts |got - ref| <= tol everywhere."""
    if got.dtype == torch.bfloat16:
        d = (_ordered(got) - _ordered(ref)).abs()
        worst = f"{int(d.max())} ulps"
    else:
        d = (got - ref).abs()
        worst = f"{float((d / ref.abs().clamp_min(1e-30)).max()):.3e} relative"
    equal = float((d == 0).float().mean())
    print(f"\n{tag}: bit-equal {equal:.6f}, largest {worst}")
    bad = (got.float() - ref.float()).abs() > tol
    assert not bool(bad.any()), f"{tag}: {int(bad.sum())} elements beyond the rule"
    assert bool(torch.isfinite(got).all())


def _ulp(t):
    """One bf16 ulp at |t| (fp32): 2^(exponent - 7), normals only."""
    e = torch.frexp(t.float().abs().clamp_min(2.0 ** -126))[1]
    return torch.ldexp(torch.ones_like(t, dtype=torch.float32), e - 8)


@pytest.mark.parametrize("H", sorted(MAIN_M))
def test_rms_norm_kernel_is_its_arithmetic_and_near_plain(gen, H):
    for M in (1, 131, MAIN_M[H]):
        x, w, _ = _inputs(gen, M, H, torch.bfloat16)
        norms.reset_counters()
        got = norms.rms_norm(x, w, EPS)
        assert norms.LAUNCHES["rms_norm"] == 1
        assert got.dtype == torch.bfloat16 and got.shape == x.shape
        exact = emulate_rms(x, w).bfloat16()
        assert torch.equal(got, exact), f"({M},{H}) differs from its emulation"
        ref = norms.rms_norm_plain(x, w, EPS)
        tol = 2 * _ulp(torch.maximum(got.float().abs(), ref.float().abs()))
        _report(f"rms_norm ({M},{H}) against plain", got, ref, tol)


@pytest.mark.parametrize("wdtype", [torch.bfloat16, torch.float32], ids=["w_bf16", "w_f32"])
@pytest.mark.parametrize("H", sorted(LN_M))
def test_layer_norm_kernel_is_its_arithmetic_and_near_plain(gen, H, wdtype):
    for M in (1, 131, LN_M[H]):
        x, w, b = _inputs(gen, M, H, wdtype)
        norms.reset_counters()
        got = norms.layer_norm(x, w, b, EPS)
        assert norms.LAUNCHES["layer_norm"] == 1
        assert got.dtype == torch.bfloat16 and got.shape == x.shape
        y = emulate_ln(x, w, b)
        assert torch.equal(got, y.bfloat16()), f"({M},{H}) differs from its emulation"
        ref = norms.layer_norm_plain(x, w, b, EPS)
        terms = (y - b.float()).abs() + b.float().abs()
        tol = _ulp(torch.maximum(got.float().abs(), ref.float().abs())) + 2.0 ** -20 * terms
        _report(f"layer_norm ({M},{H}) {wdtype} against plain", got, ref, tol)


def test_norm_kernel_on_leading_axes_and_a_zero_row(gen):
    """(crops, tokens, H) in, the same shape out; a zero row normalises to
    zero (RMSNorm) and to the bias (LayerNorm)."""
    x = torch.randn(3, 37, 1024, generator=gen, device="cuda").bfloat16()
    x[1, 5] = 0
    w = torch.randn(1024, generator=gen, device="cuda").bfloat16()
    b = torch.randn(1024, generator=gen, device="cuda").bfloat16()
    r, n = norms.rms_norm(x, w, EPS), norms.layer_norm(x, w, b, EPS)
    assert r.shape == x.shape and n.shape == x.shape
    assert not bool(r[1, 5].any()) and torch.equal(n[1, 5], b)
    assert torch.equal(r, emulate_rms(x.view(-1, 1024), w).bfloat16().view_as(x))


def test_b4_codes_are_those_of_the_norm_row(gen):
    """B4 rounds its bf16 row as the norm mode stores it: its codes are the
    plain row quantizer's codes of the norm kernel's output, bit for bit."""
    for M, H in ((20480, 3072), (14336, 3584), (23808, 5120), (131, 1024)):
        x, w, _ = _inputs(gen, M, H, torch.bfloat16)
        codes, amax = qe.rms_quant(x, w, EPS)
        rc, ra = qe.row_quant_plain(norms.rms_norm(x, w, EPS))
        assert torch.equal(codes, rc) and torch.equal(amax, ra), (M, H)


@pytest.mark.parametrize("kind,M,H", [("rms_quant", 20480, 3072), ("rms_quant", 14336, 3584),
                                      ("rms_quant", 23808, 5120), ("ln_quant", 87040, 1024),
                                      ("ln_quant", 21760, 1024)])
def test_b4_b9_codes_at_their_shapes_are_bit_exact(gen, kind, M, H):
    """B4 and B9 at PERF.md's shapes: codes and amax equal the plain row
    quantizer's on the emulated row (B4: bf16-rounded; B9: fp32), bit for
    bit, so the norm mode left their arithmetic as it was."""
    x, w, b = _inputs(gen, M, H, torch.bfloat16)
    if kind == "rms_quant":
        got, y = qe.rms_quant(x, w, EPS), emulate_rms(x, w).bfloat16().float()
    else:
        got, y = qe.ln_quant(x, w, b, EPS), emulate_ln(x, w, b)
    want = qe.row_codes(y)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_norms_keep_the_plain_code_for_what_the_kernel_does_not_take(gen):
    """fp32 rows, a width not a multiple of 16 or above 5120, a strided view,
    a weight of another dtype, an f32 RMSNorm weight (its product is f32), a
    LayerNorm wider than 2048, and inputs under autograd take the plain code,
    with its values and its gradient; nothing is launched."""
    norms.reset_counters()
    x = torch.randn(9, 1024, generator=gen, device="cuda").bfloat16()
    w = torch.randn(1024, generator=gen, device="cuda").bfloat16()
    b = torch.zeros(1024, device="cuda", dtype=torch.bfloat16)
    cases = [
        (x.float(), w, b),
        (torch.randn(9, 136, generator=gen, device="cuda").bfloat16(), w[:136], b[:136]),
        (torch.randn(9, 5376, generator=gen, device="cuda").bfloat16(),
         torch.ones(5376, device="cuda", dtype=torch.bfloat16),
         torch.zeros(5376, device="cuda", dtype=torch.bfloat16)),
        (torch.randn(1024, 9, generator=gen, device="cuda").bfloat16().t(), w, b),
        (x, w.half(), b.half()),
    ]
    for xi, wi, bi in cases:
        assert torch.equal(norms.rms_norm(xi, wi, EPS), norms.rms_norm_plain(xi, wi, EPS))
        assert torch.equal(norms.layer_norm(xi, wi, bi, EPS),
                           norms.layer_norm_plain(xi, wi, bi, EPS))
    got = norms.rms_norm(x, w.float(), EPS)
    assert got.dtype == torch.float32 and torch.equal(got, norms.rms_norm_plain(x, w.float(), EPS))
    x3, w3 = (torch.randn(9, 3072, generator=gen, device="cuda").bfloat16(),
              torch.randn(3072, generator=gen, device="cuda").bfloat16())
    assert torch.equal(norms.layer_norm(x3, w3, w3, EPS), norms.layer_norm_plain(x3, w3, w3, EPS))
    wg = w.clone().requires_grad_()
    out = norms.rms_norm(x, wg, EPS)
    assert out.grad_fn is not None
    out.float().sum().backward()
    assert wg.grad is not None and bool(torch.isfinite(wg.grad).all())
    assert not any(norms.LAUNCHES.values())
    with torch.no_grad():
        norms.rms_norm(x, wg, EPS)
    assert norms.LAUNCHES["rms_norm"] == 1
