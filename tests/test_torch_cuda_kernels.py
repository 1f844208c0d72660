"""The port's hand-written CUDA kernels against their plain versions, on the
card. They need an NVIDIA Hopper card with ``nvcc`` and skip elsewhere: a
CUDA kernel has no CPU mode (the plain versions are held to the JAX
package's interpreted Pallas kernels in tests/test_torch_attention.py and
tests/test_torch_quant_kernels.py).

``chip_smoke.py`` checks the kernels at the serving path's shapes; these
tests cover the options that path does not reach. Attention: sliding
window, GQA (n_rep > 1), head_dim 128, a ``valid_len`` / ``q_len`` tail, S
not a multiple of the 64-row tile, a query tile of pure left pad. W8A8:
B4-B6 on f32 input, B5 at I = 256 and 18944 (Qwen2.5-VL's), the GEMM at a
ragged M, at M < 16, at K and N that the 64 x 128 tiles do not divide and
with f32 output; the weight quantizers on the card against the CPU's. And
the wrappers' refusals. Inputs come from a seeded CUDA
generator.

Tolerances. Attention, on valid rows: |kernel - plain| <= 8e-3 + 2^-7
|plain|, about one bf16 ulp (the two round the probabilities at different
points); pad rows must be finite. B2 (RoPE + relayout), B6 (row quantize)
and B7 (the int8 GEMM, integer sums) must be bit-exact. B4 sums x^2 in
another order than its plain version: codes within one on under 0.1 % of
elements, amax within one bf16 ulp. B5: codes within one on under 2 % of
elements (the JAX package's rule for sigmoid's rounding).

Run on a machine with the card; these tests need no JAX, so the suite's
conftest, which imports JAX, can be left out:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_kernels.py -q
"""

import pytest
import torch

from llava_reward_torch.ops import flash_attention as fa
from llava_reward_torch.ops import int8_matmul as im
from llava_reward_torch.ops import quant_epilogue as qe

pytestmark = pytest.mark.cuda

ATOL, RTOL = 8e-3, 2 ** -7


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.Generator(device="cuda").manual_seed(0)


def _randn(gen, *shape):
    return torch.randn(*shape, generator=gen, device="cuda", dtype=torch.bfloat16)


def _valid_rows(S, kv_start, q_len):
    rows = torch.arange(S, device="cuda")[None, :]
    return (rows >= torch.tensor(kv_start, device="cuda")[:, None]) & (rows < q_len)


def _assert_close_on(valid, out, ref):
    """out/ref (B, S, ...) with valid (B, S) query rows."""
    o, r = out[valid].float(), ref[valid].float()
    bad = (o - r).abs() > ATOL + RTOL * r.abs()
    assert not bool(bad.any()), f"max abs err {(o - r).abs().max().item():.3e}"
    assert bool(torch.isfinite(out).all())


DIRECT_CASES = {
    # name: (B, S, H, D, causal, rope, kv_start, valid_len, window)
    "decoder_causal_rope_leftpad": (2, 256, 4, 96, True, True, [0, 37], None, None),
    "clip_valid_len": (2, 256, 2, 64, False, False, [0, 0], 200, None),
    "causal_window_leftpad": (2, 256, 4, 96, True, True, [70, 3], None, 40),
    "head_dim_128": (1, 192, 2, 128, True, True, [5], None, None),
}


@pytest.mark.parametrize("case", sorted(DIRECT_CASES))
def test_direct_kernel_matches_plain(gen, case):
    B, S, H, D, causal, rope, kv_start, valid_len, window = DIRECT_CASES[case]
    qkv = _randn(gen, B, S, 3 * H * D)
    cos = sin = None
    if rope:
        ang = torch.rand(B, S, D, generator=gen, device="cuda") * 6.3
        cos, sin = ang.cos().bfloat16(), ang.sin().bfloat16()
    kv = torch.tensor(kv_start, dtype=torch.int32, device="cuda")
    kw = dict(n_heads=H, head_dim=D, causal=causal, sliding_window=window,
              scale=D ** -0.5, valid_len=valid_len)
    fa.reset_counters()
    out = fa.direct_attention(qkv, cos, sin, kv, **kw)
    assert fa.LAUNCHES["fa_direct"] == 1 and fa.PLAIN_CALLS["fa_direct"] == 0
    ref = fa.fa_direct_plain(qkv, cos, sin, kv, **kw)
    torch.cuda.synchronize()
    _assert_close_on(_valid_rows(S, kv_start, valid_len or S), out, ref)


HM_CASES = {
    # name: (B, S, H, Hk, D, causal, kv_start, q_len, window)
    "causal_leftpad": (2, 256, 4, 4, 96, True, [0, 51], 256, None),
    "q_len_tail": (2, 256, 2, 2, 64, False, [0, 0], 190, None),
    "causal_window": (2, 256, 4, 4, 96, True, [10, 0], 256, 33),
    "gqa_causal_leftpad": (2, 256, 4, 2, 64, True, [5, 64], 256, None),
    "ragged_s_d128_pad_tile": (2, 200, 2, 1, 128, True, [0, 70], 200, None),
}


@pytest.mark.parametrize("case", sorted(HM_CASES))
def test_head_major_kernel_matches_plain(gen, case):
    B, S, H, Hk, D, causal, kv_start, q_len, window = HM_CASES[case]
    qt, kt, vt = _randn(gen, B, H, S, D), _randn(gen, B, Hk, S, D), _randn(gen, B, Hk, S, D)
    kv = torch.tensor(kv_start, dtype=torch.int32, device="cuda")
    kw = dict(causal=causal, sliding_window=window, scale=D ** -0.5, q_len=q_len)
    fa.reset_counters()
    out = fa._flash_fwd_hm(qt, kt, vt, kv, None, **kw)
    assert fa.LAUNCHES["fa_hm"] == 1 and fa.PLAIN_CALLS["fa_hm"] == 0
    ref = fa.flash_fwd_hm_plain(qt, kt, vt, kv, **kw)
    torch.cuda.synchronize()
    _assert_close_on(_valid_rows(S, kv_start, q_len), out.transpose(1, 2), ref.transpose(1, 2))


@pytest.mark.parametrize("D", [64, 96, 128])
@pytest.mark.parametrize("rope", [True, False])
def test_rope_transpose_kernel_is_bit_exact(gen, D, rope):
    B, S, H = 2, 136, 3
    x = _randn(gen, B, S, 3 * H * D)
    cos = sin = None
    if rope:
        ang = torch.rand(B, S, D, generator=gen, device="cuda") * 6.3
        cos, sin = ang.cos().bfloat16(), ang.sin().bfloat16()
    kw = dict(col_offset=H * D, n_heads=H, head_dim=D)
    fa.reset_counters()
    out = fa.rope_transpose(x, cos, sin, **kw)
    assert fa.LAUNCHES["prep"] == 1 and fa.PLAIN_CALLS["prep"] == 0
    assert torch.equal(out, fa.rope_transpose_plain(x, cos, sin, **kw))


def test_wrappers_refuse_what_the_kernels_do_not_take(gen):
    kv = torch.zeros(1, dtype=torch.int32, device="cuda")
    with pytest.raises(ValueError, match="head_dim"):
        fa.direct_attention(_randn(gen, 1, 64, 3 * 2 * 80), None, None, kv, n_heads=2,
                            head_dim=80, causal=False, sliding_window=None, scale=0.1)
    with pytest.raises(ValueError, match="bf16"):
        fa.rope_transpose(_randn(gen, 1, 64, 128).float(), None, None, col_offset=0,
                          n_heads=2, head_dim=64)
    hm = _randn(gen, 1, 2, 64, 64)
    with pytest.raises(NotImplementedError, match="slice 5"):
        fa._flash_fwd_hm(hm, hm, hm, kv, torch.ones(1, 64, device="cuda"), False, None,
                         0.125, q_len=64)


# ------------------------------------------------------------------ W8A8


def _rows(gen, M, n, dtype):
    x = torch.randn(M, n, generator=gen, device="cuda").mul_(3).to(dtype)
    x[M // 2] = 0  # a zero row: amax := 1
    return x


def _check_codes(name, got, ref):
    (c, a), (rc, ra) = got, ref
    d = (c.int() - rc.int()).abs()
    share = (d > 0).float().mean().item()
    if name == "row_quant":
        assert torch.equal(c, rc) and torch.equal(a, ra)
    else:
        assert d.max().item() <= 1 and share < (1e-3 if name == "rms_quant" else 0.02), share
        assert torch.allclose(a, ra, rtol=2 ** -7, atol=0)
    assert float(a[c.shape[0] // 2]) == 1.0 and not bool(c[c.shape[0] // 2].any())


@pytest.mark.parametrize("name", ["rms_quant", "silu_mul_quant", "row_quant"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_quant_epilogue_kernels_match_plain(gen, name, dtype):
    M, H = 77, 384
    qe.reset_counters()
    if name == "rms_quant":
        x = _rows(gen, M, H, dtype)
        w = torch.randn(H, generator=gen, device="cuda").to(dtype)
        got, ref = qe.rms_quant(x, w, 1e-5), qe.rms_quant_plain(x, w, 1e-5)
    elif name == "silu_mul_quant":
        x = _rows(gen, M, 2 * H, dtype)
        got, ref = qe.silu_mul_quant(x), qe.silu_mul_quant_plain(x)
    else:
        x = _rows(gen, M, H, dtype)
        got, ref = qe.row_quant(x), qe.row_quant_plain(x)
    assert qe.LAUNCHES[name] == 1 and qe.PLAIN_CALLS[name] == 1
    torch.cuda.synchronize()
    _check_codes(name, got, ref)


@pytest.mark.parametrize("I", [256, 18944])
def test_silu_mul_quant_kernel_at_other_widths(gen, I):
    x = _rows(gen, 40, 2 * I, torch.bfloat16)
    got = qe.silu_mul_quant(x.reshape(2, 20, 2 * I))
    assert tuple(got[0].shape) == (2, 20, I) and tuple(got[1].shape) == (2, 20, 1)
    torch.cuda.synchronize()
    _check_codes("silu_mul_quant", (got[0].reshape(40, I), got[1].reshape(40, 1)),
                 qe.silu_mul_quant_plain(x))


GEMM_CASES = {
    # name: (M, K, N, out dtype)
    "ragged_m_bf16": (200, 384, 256, torch.bfloat16),
    "m_below_16_f32": (5, 256, 384, torch.float32),
    "k_n_off_tile_f32": (130, 208, 272, torch.float32),
    "k_n_off_tile_bf16": (64, 8192 + 16, 48, torch.bfloat16),
}


@pytest.mark.parametrize("case", sorted(GEMM_CASES))
def test_int8_matmul_kernel_is_bit_exact(gen, case):
    M, K, N, out_dtype = GEMM_CASES[case]
    x = _rows(gen, M, K, torch.bfloat16)
    wq = torch.randint(-127, 128, (K, N), generator=gen, device="cuda", dtype=torch.int8)
    ws = torch.rand(1, N, generator=gen, device="cuda") * 1e-3 + 1e-4
    im.reset_counters()
    qe.reset_counters()
    dyn = im.w8a8_matmul(x, wq, ws, out_dtype)
    assert im.LAUNCHES["int8_matmul"] == 1 and qe.LAUNCHES["row_quant"] == 1
    codes, amax = qe.row_quant_plain(x)
    pre = im.int8_matmul_pre(codes, amax, wq, ws, out_dtype)
    ref = im.int8_matmul_pre_plain(codes, amax, wq, ws, out_dtype)
    torch.cuda.synchronize()
    assert dyn.dtype == out_dtype and tuple(dyn.shape) == (M, N)
    assert torch.equal(pre, ref) and torch.equal(dyn, ref)
    assert not bool(dyn[M // 2].any())


@pytest.mark.parametrize("scheme", ["w8a8", "absmax", "nf4"])
def test_quantizers_on_the_card_match_the_cpu(gen, scheme):
    """The decoder is quantized on the card: its codes and scales must be
    the CPU's (which tests/test_torch_quantize.py holds to JAX's)."""
    from llava_reward_torch.utils.quantize import quantize_stacked_layers

    w = torch.randn(2, 3072, 320, generator=gen, device="cuda").mul_(0.02).bfloat16()
    w[0, :, 5] = 0
    on_card = quantize_stacked_layers({"w": w}, scheme=scheme, min_size=0)["w"]
    on_cpu = quantize_stacked_layers({"w": w.cpu()}, scheme=scheme, min_size=0)["w"]
    assert on_card.keys() == on_cpu.keys()
    for k in on_cpu:
        assert torch.equal(on_card[k].cpu(), on_cpu[k]), k


def test_w8a8_wrappers_refuse_what_the_kernels_do_not_take(gen):
    codes = torch.zeros(32, 200, dtype=torch.int8, device="cuda")
    amax = torch.ones(32, 1, device="cuda")
    with pytest.raises(ValueError, match="multiples of 16"):  # K = 200
        im.int8_matmul_pre(codes, amax, torch.zeros(200, 64, dtype=torch.int8, device="cuda"),
                           torch.ones(1, 64, device="cuda"))
    with pytest.raises(ValueError, match="multiples of 16"):  # N = 40
        im.int8_matmul_pre(codes[:, :192], amax,
                           torch.zeros(192, 40, dtype=torch.int8, device="cuda"),
                           torch.ones(1, 40, device="cuda"))
    attn = _randn(gen, 2, 64, 4, 128).transpose(1, 2)  # (B, H, S, D): not a row layout
    with pytest.raises(ValueError, match="not contiguous"):
        qe.row_quant(attn.reshape(2, 4, 64 * 128)[:, :, :256])
    with pytest.raises(ValueError, match="not contiguous"):
        qe.row_quant(attn)
