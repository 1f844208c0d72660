"""The port's hand-written CUDA kernels against their plain versions, on the
card. They need an NVIDIA Hopper card with ``nvcc`` and skip elsewhere: a
CUDA kernel has no CPU mode (the plain versions are held to the JAX
package's interpreted Pallas kernels in tests/test_torch_attention.py).

``chip_smoke.py`` checks the kernels at the serving path's shapes; these
tests cover the options that path does not reach: sliding window, GQA
(n_rep > 1), head_dim 128, a ``valid_len`` / ``q_len`` tail, S not a
multiple of the 64-row tile, a query tile of pure left pad, and the
wrappers' refusals. Inputs are bf16 from a seeded CUDA generator.
Tolerance on valid rows: |kernel - plain| <= 8e-3 + 2^-7 |plain|, about
one bf16 ulp (the two round the probabilities at different points); pad
rows must be finite. B2 (RoPE + relayout) must be bit-exact.

Run on a machine with the card; these tests need no JAX, so the suite's
conftest, which imports JAX, can be left out:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_kernels.py -q
"""

import pytest
import torch

from llava_reward_torch.ops import flash_attention as fa

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
