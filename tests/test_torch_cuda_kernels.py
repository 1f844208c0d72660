"""The port's hand-written CUDA kernels against their plain versions, on the
card. They need an NVIDIA Hopper card with ``nvcc`` and skip elsewhere: a
CUDA kernel has no CPU mode (the plain versions are held to the JAX
package's interpreted Pallas kernels in tests/test_torch_attention.py and
tests/test_torch_quant_kernels.py).

``chip_smoke.py`` checks the kernels at the main paths' shapes; these
tests cover the options those paths do not reach. Attention: sliding
window, GQA (n_rep > 1), head_dim 128, a ``valid_len`` / ``q_len`` tail, S
not a multiple of the 64-row tile (S = 48, below one tile, and CLIP's 577),
query tiles of pure left pad (B1 with RoPE and a window at head_dim 96); B3's
key-mask mode with interleaved pads, segment ids 1, 2, 3 and 0 in one row
(video frames), segments with GQA, head_dim 80 causal with a window, and
rows whose every key is masked (finite). The
backward (B8): the same options and GQA n_rep 4 and 7 (Qwen2.5-VL's 28/4
at head_dim 128, also over 14 key tiles), with g zeroed on fully
masked rows as on the training path, and finite outputs when g is not zero
there; its key-mask and segment modes (one and several segments per row,
head_dim 80, GQA, ragged S) with g NOT zeroed on pad queries where every key
tile is visited: dq on the queries that have a key, dk and dv on every valid
key, so a pad query leaking into a valid key otherwise than in the plain
version shows; and two launches on the same inputs, which may differ by one
bf16 rounding of a gradient (fp32 sums in the order blocks finish), and
not at all in dk / dv without GQA. Every raw launch refuses an input that
requires grad; a head_dim below the kernels' (16) runs them zero-padded to
64, as the Pallas kernels pad to a lane width. W8A8:
B4-B6 and B9 on f32 and bf16 input, B9 on an odd row count and a zero row,
the streaming B4 / B9 at widths 128-5120 on one row, a prime row count and
10007 rows (the ring wraps), bf16 weights read as their f32 widening, and the
widths it refuses (136, 5376) raising ValueError before any launch;
B6's three modes bit-exact at every width of the main paths and at 8 k widths
of its block form (a whole f32 row of 58112, too large to keep in shared
memory, read twice), on 1, 131 and 2053 rows, and the widths it refuses (not
8 k) raising ValueError before any launch; B5 at I = 256 and 18944 (Qwen2.5-VL's), the GEMM on K-major weights at a
ragged M, at M < 16, at K and N that the 128 x 256 tiles and 128-deep K
steps do not divide (K = 208 and 8192 + 16, N = 48) and with f32 output,
and packed int4 run as W8A8 through it; B5 and B6 in their tensor-parallel
modes (the raw absmax of a rank's columns, the codes on a given amax) against
their plain versions and, split over 2 and 4 ranks and MAX-reduced, against
the kernel's own whole-row codes bit for bit (K = 1792 and 13824: both of
B6's forms); the GEMM on a rank's K-major
row block and column block of a stacked W8A8 leaf (``tp_block``), bit-exact,
its partial sums adding up to the whole product; ``_Int8LinearCore`` at
LLaVA-NeXT's
projections (forward through B6 + the GEMM, the bf16 tensor-core backward
within one bf16 rounding of the fp32 product); the weight quantizers on the card
against the CPU's. And the wrappers' refusals (an N-major weight among
them). B3 also on q and k/v as strided views of one fused projection, and
twice on the same inputs: it uses no atomics, so the two agree exactly. Inputs come from a seeded CUDA
generator.

Tolerances. Attention, on valid rows: |kernel - plain| <= 8e-3 + 2^-7
|plain|, about one bf16 ulp (the two round the probabilities at different
points); pad rows must be finite. B8: |kernel - plain| <= 2^-7 |plain| +
2^-8 max|plain| per gradient (one bf16 ulp of the output, plus the rare
bf16 rounding of p or ds that the two take on either side of a boundary).
B2 (RoPE + relayout), B6 (row quantize) and B7 (the int8 GEMM, integer
sums) must be bit-exact. B4 and B9 take
their row sums in another order than their plain versions: codes within one
on under 0.1 % of elements, amax within one bf16 ulp. B5: codes within one on under 2 % of
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
    "short_s48": (2, 48, 2, 64, False, False, [0, 0], None, None),
    "ragged_s577": (1, 577, 2, 64, False, False, [0], None, None),
    "pad_tiles_d96_rope_window": (2, 384, 4, 96, True, True, [0, 200], None, 70),
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
    "gqa_rep7_d128_ragged": (2, 200, 14, 2, 128, True, [0, 40], 200, None),
    "causal_window_leftpad_d80": (2, 320, 2, 2, 80, True, [70, 3], 320, 45),
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


def test_head_major_kernel_on_views_of_one_fused_buffer(gen):
    """q and k/v as strided (B, H, S, D) views of one (B, S, (H + 2 Hk) * D)
    projection, as the tensor maps read them: the same result as on
    contiguous copies, and within tolerance of the plain version."""
    B, S, H, Hk, D = 2, 200, 4, 2, 96
    qkv = _randn(gen, B, S, (H + 2 * Hk) * D)
    q = qkv[..., : H * D].unflatten(-1, (H, D)).transpose(1, 2)
    k = qkv[..., H * D : (H + Hk) * D].unflatten(-1, (Hk, D)).transpose(1, 2)
    v = qkv[..., (H + Hk) * D :].unflatten(-1, (Hk, D)).transpose(1, 2)
    kv = torch.tensor([0, 33], dtype=torch.int32, device="cuda")
    kw = dict(causal=True, sliding_window=None, scale=D ** -0.5, q_len=S)
    out = fa._flash_fwd_hm(q, k, v, kv, None, **kw)
    dense = fa._flash_fwd_hm(q.contiguous(), k.contiguous(), v.contiguous(), kv, None, **kw)
    ref = fa.flash_fwd_hm_plain(q, k, v, kv, **kw)
    torch.cuda.synchronize()
    assert torch.equal(out, dense)
    _assert_close_on(_valid_rows(S, [0, 33], S), out.transpose(1, 2), ref.transpose(1, 2))


def test_head_major_kernel_repeats_exactly(gen):
    """B3 sums in a fixed order (no atomics): two launches agree bit for bit,
    in left-pad mode with GQA and in segment mode."""
    B, S, D = 2, 200, 128
    q, k, v = _randn(gen, B, 14, S, D), _randn(gen, B, 2, S, D), _randn(gen, B, 2, S, D)
    kv = torch.tensor([0, 40], dtype=torch.int32, device="cuda")
    kw = dict(causal=True, sliding_window=None, scale=D ** -0.5, q_len=S)
    first = fa._flash_fwd_hm(q, k, v, kv, None, **kw)
    assert torch.equal(first, fa._flash_fwd_hm(q, k, v, kv, None, **kw))
    seg = torch.stack([_mask_row(S, "frames"), _mask_row(S, "pads")]).cuda()
    q, k, v = (_randn(gen, B, 2, S, 80) for _ in range(3))
    kw = dict(causal=False, sliding_window=None, scale=80 ** -0.5, q_len=S, segments=True)
    zero = torch.zeros(B, dtype=torch.int32, device="cuda")
    first = fa._flash_fwd_hm(q, k, v, zero, seg, **kw)
    assert torch.equal(first, fa._flash_fwd_hm(q, k, v, zero, seg, **kw))
    torch.cuda.synchronize()


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
    with pytest.raises(ValueError, match="key_mask must be"):
        fa._flash_fwd_hm(hm, hm, hm, kv, torch.ones(1, 63, device="cuda"), False, None,
                         0.125, q_len=64, segments=True)
    hm48 = _randn(gen, 1, 2, 64, 48)
    with pytest.raises(ValueError, match="head_dim"):
        fa._flash_fwd_hm(hm48, hm48, hm48, kv, None, False, None, 0.125, q_len=64)
    # a view one element into its buffer: the tensor maps need 16-byte aligned bases
    off = _randn(gen, 1, 2, 64, 72)[..., 1:65]
    with pytest.raises(ValueError, match="16-byte aligned"):
        fa._flash_fwd_hm(off, hm, hm, kv, None, False, None, 0.125, q_len=64)
    bwd_kw = dict(causal=False, sliding_window=None, scale=0.125, q_len=64)
    with pytest.raises(ValueError, match="head_dim"):
        fa.flash_bwd(hm48, hm48, hm48, hm48, kv, **bwd_kw)
    with pytest.raises(ValueError, match="key_mask must be"):
        fa.flash_bwd(hm, hm, hm, hm, kv, key_mask=torch.ones(2, 64, device="cuda"), **bwd_kw)
    with pytest.raises(ValueError, match="bf16"):
        fa.flash_bwd(hm, hm, hm, hm.float(), kv, **bwd_kw)


def _mask_row(S, pattern):
    """(S,) int32: 'pads' ones with interleaved pad runs; 'frames' segment
    ids 1, 2, 3 in runs, with pad slots (0) among them; 'none' all zero."""
    row = torch.ones(S, dtype=torch.int32)
    if pattern == "frames":
        row[: S // 3], row[S // 3 : 2 * S // 3], row[2 * S // 3 :] = 1, 2, 3
    if pattern in ("pads", "frames"):
        for start in torch.randint(0, S - 16, (4,), generator=torch.Generator().manual_seed(S)):
            row[start : start + 11] = 0
    if pattern == "none":
        row[:] = 0
    return row


MASK_CASES = {
    # name: (B, S, H, Hk, D, causal, window, mask layout, pattern per batch row)
    "key_mask_pads_d80": (2, 320, 2, 2, 80, False, None, "arbitrary", ("pads", "pads")),
    "segments_frames_d80": (2, 256, 2, 2, 80, False, None, "segments", ("frames", "pads")),
    "segments_gqa_d64": (2, 192, 4, 2, 64, False, None, "segments", ("frames", "pads")),
    "segments_d128_ragged": (1, 200, 2, 1, 128, False, None, "segments", ("frames",)),
    "segments_d80_ragged": (2, 200, 2, 2, 80, False, None, "segments", ("frames", "pads")),
    "key_mask_causal_window_d96": (2, 256, 4, 4, 96, True, 40, "arbitrary", ("pads", "pads")),
    "d80_causal_window_no_mask": (2, 256, 2, 1, 80, True, 50, None, ()),
    "all_keys_masked_row": (2, 128, 2, 2, 80, False, None, "segments", ("none", "pads")),
}


@pytest.mark.parametrize("case", sorted(MASK_CASES))
def test_masked_head_major_kernel_matches_plain(gen, case):
    """B3's key-mask and segment modes (and head_dim 80) against the plain
    version on the query rows that have a key to attend to; every row,
    fully masked ones included, finite."""
    B, S, H, Hk, D, causal, window, layout, patterns = MASK_CASES[case]
    qt, kt, vt = _randn(gen, B, H, S, D), _randn(gen, B, Hk, S, D), _randn(gen, B, Hk, S, D)
    kv = torch.zeros(B, dtype=torch.int32, device="cuda")
    seg = layout == "segments"
    pos = torch.arange(S, device="cuda")
    ok = torch.ones(B, S, S, dtype=torch.bool, device="cuda")  # (b, query, key)
    key_mask = None
    if layout is not None:
        key_mask = torch.stack([_mask_row(S, p) for p in patterns]).cuda()
        ok &= key_mask[:, None, :] != 0
        if seg:
            ok &= key_mask[:, None, :] == key_mask[:, :, None]
    if causal:
        ok &= pos[None, None, :] <= pos[None, :, None]
        if window is not None:
            ok &= pos[None, None, :] > pos[None, :, None] - window
    kw = dict(causal=causal, sliding_window=window, scale=D ** -0.5, q_len=S)
    fa.reset_counters()
    out = fa._flash_fwd_hm(qt, kt, vt, kv, key_mask, segments=seg, **kw)
    assert fa.LAUNCHES["fa_hm"] == 1 and fa.PLAIN_CALLS["fa_hm"] == 0
    ref = fa.flash_fwd_hm_plain(qt, kt, vt, kv, key_mask=key_mask, segments=seg, **kw)
    torch.cuda.synchronize()
    _assert_close_on(ok.any(-1), out.transpose(1, 2), ref.transpose(1, 2))


BWD_RTOL, BWD_ATOL_SHARE = 2 ** -7, 2 ** -8

BWD_CASES = {
    # name: (B, S, H, Hk, D, causal, kv_start, q_len, window)
    "causal_leftpad_d96": (2, 256, 4, 4, 96, True, [0, 37], 256, None),
    "causal_window_d96": (2, 256, 4, 4, 96, True, [10, 0], 256, 33),
    "gqa_rep2_d64": (2, 256, 4, 2, 64, True, [5, 64], 256, None),
    "gqa_rep4_noncausal_d128": (1, 192, 4, 1, 128, False, [0], 192, None),
    "ragged_s_qlen_tail_d64": (2, 200, 2, 2, 64, False, [0, 0], 170, None),
    "pad_tile_ragged_d128": (2, 200, 2, 1, 128, True, [0, 70], 200, None),
    "gqa_rep7_leftpad_d128": (2, 448, 14, 2, 128, True, [0, 40], 448, None),
    "d80_causal_window": (2, 256, 2, 1, 80, True, [0, 9], 256, 50),
    "d80_noncausal_ragged": (1, 200, 2, 2, 80, False, [0], 200, None),
    "short_s48_d64": (2, 48, 2, 2, 64, False, [0, 0], 48, None),
    "clip_s577_d64": (2, 577, 2, 2, 64, False, [0, 0], 577, None),
    "pad_q_tiles_leftpad_d96": (2, 320, 2, 2, 96, True, [0, 150], 320, None),
    "gqa_rep7_d128_many_tiles": (2, 896, 14, 2, 128, True, [0, 40], 896, None),
}


def _bwd_case(gen, case, zero_pad_rows=True):
    B, S, H, Hk, D, causal, kv_start, q_len, window = BWD_CASES[case]
    qt, gt = _randn(gen, B, H, S, D), _randn(gen, B, H, S, D)
    kt, vt = _randn(gen, B, Hk, S, D), _randn(gen, B, Hk, S, D)
    rows = torch.arange(S, device="cuda")[None, :].expand(B, S)
    masked = rows < torch.tensor(kv_start, device="cuda")[:, None] if causal else rows < 0
    if zero_pad_rows:
        gt = gt * (~masked)[:, None, :, None].to(gt.dtype)
    kv = torch.tensor(kv_start, dtype=torch.int32, device="cuda")
    kw = dict(causal=causal, sliding_window=window, scale=D ** -0.5, q_len=q_len)
    return (qt, kt, vt, gt, kv), kw, ~masked


@pytest.mark.parametrize("case", sorted(BWD_CASES))
def test_attention_bwd_kernel_matches_plain(gen, case):
    args, kw, live = _bwd_case(gen, case)
    fa.reset_counters()
    got = fa.flash_bwd(*args, **kw)
    assert fa.LAUNCHES["fa_bwd"] == 1 and fa.PLAIN_CALLS["fa_bwd"] == 0
    ref = fa.flash_bwd_plain(*args, **kw)
    torch.cuda.synchronize()
    for name, o, r in zip(("dq", "dk", "dv"), got, ref):
        assert bool(torch.isfinite(o).all()), name
        if name == "dq":  # a fully masked row's dq depends on the keys visited
            o, r = o.transpose(1, 2)[live], r.transpose(1, 2)[live]
        o, r = o.float(), r.float()
        tol = BWD_RTOL * r.abs() + BWD_ATOL_SHARE * r.abs().max()
        err = (o - r).abs()
        assert bool((err <= tol).all()), f"{name}: max abs err {err.max().item():.3e}"


MASK_BWD_CASES = {
    # name: (B, S, H, Hk, D, causal, window, mask layout, pattern per batch row)
    "key_mask_pads_d80": (2, 320, 2, 2, 80, False, None, "arbitrary", ("pads", "pads")),
    "key_mask_gqa_rep4_d128": (2, 256, 4, 1, 128, False, None, "arbitrary", ("pads", "pads")),
    "key_mask_causal_window_d96": (2, 256, 4, 4, 96, True, 40, "arbitrary", ("pads", "pads")),
    "segments_one_d80": (2, 256, 2, 2, 80, False, None, "segments", ("pads", "pads")),
    "segments_frames_d80": (2, 256, 2, 2, 80, False, None, "segments", ("frames", "pads")),
    "segments_gqa_d64": (2, 192, 4, 2, 64, False, None, "segments", ("frames", "pads")),
    "segments_d128_ragged": (1, 200, 2, 1, 128, False, None, "segments", ("frames",)),
    "segments_d80_ragged": (2, 200, 2, 2, 80, False, None, "segments", ("frames", "pads")),
    "segments_all_pad_row_d80": (2, 128, 2, 2, 80, False, None, "segments", ("none", "pads")),
    "segments_d80_ragged_tile": (2, 200, 2, 2, 80, False, None, "segments", ("frames", "pads")),
    "key_mask_s577_d64": (1, 577, 2, 1, 64, False, None, "arbitrary", ("pads",)),
}


@pytest.mark.parametrize("case", sorted(MASK_BWD_CASES))
def test_masked_attention_bwd_kernel_matches_plain(gen, case):
    """B8's key-mask and segment modes against the plain version. Non-causal
    cases keep g on the pad queries: their uniform p reaches dk and dv of
    every key, and must do so as in the plain version."""
    B, S, H, Hk, D, causal, window, layout, patterns = MASK_BWD_CASES[case]
    qt, gt = _randn(gen, B, H, S, D), _randn(gen, B, H, S, D)
    kt, vt = _randn(gen, B, Hk, S, D), _randn(gen, B, Hk, S, D)
    kv = torch.zeros(B, dtype=torch.int32, device="cuda")
    seg = layout == "segments"
    key_mask = torch.stack([_mask_row(S, p) for p in patterns]).cuda()
    pos = torch.arange(S, device="cuda")
    ok = (key_mask[:, None, :] != 0).expand(B, S, S).clone()  # (b, query, key)
    if seg:
        ok &= key_mask[:, None, :] == key_mask[:, :, None]
    if causal:
        ok &= pos[None, None, :] <= pos[None, :, None]
        if window is not None:
            ok &= pos[None, None, :] > pos[None, :, None] - window
    has_key, key_valid = ok.any(-1), key_mask != 0
    if causal:  # tile skipping: a keyless row's p depends on the keys visited
        gt = gt * has_key[:, None, :, None].to(gt.dtype)
    elif seg:
        assert not bool(has_key.all())
    kw = dict(causal=causal, sliding_window=window, scale=D ** -0.5, q_len=S,
              key_mask=key_mask, segments=seg)
    fa.reset_counters()
    got = fa.flash_bwd(qt, kt, vt, gt, kv, **kw)
    assert fa.LAUNCHES["fa_bwd"] == 1 and fa.PLAIN_CALLS["fa_bwd"] == 0
    ref = fa.flash_bwd_plain(qt, kt, vt, gt, kv, **kw)
    torch.cuda.synchronize()
    for name, o, r, rows in zip(("dq", "dk", "dv"), got, ref, (has_key, key_valid, key_valid)):
        assert bool(torch.isfinite(o).all()), name
        if not bool(rows.any()):
            continue
        o, r = o.transpose(1, 2)[rows].float(), r.transpose(1, 2)[rows].float()
        tol = BWD_RTOL * r.abs() + BWD_ATOL_SHARE * r.abs().max()
        err = (o - r).abs()
        assert bool((err <= tol).all()), f"{name}: max abs err {err.max().item():.3e}"


def test_masked_flash_attention_runs_both_kernels_under_autograd(gen):
    """``flash_attention(mask_layout="segments")`` on the card: B3 forward,
    B8 backward in segment mode, gradients close to the plain route's."""
    B, S, H, D = 2, 256, 2, 80
    seg = torch.stack([_mask_row(S, "frames"), _mask_row(S, "pads")]).cuda()
    w = _randn(gen, B, S, H, D) * (seg != 0)[:, :, None, None]
    base = [_randn(gen, B, S, H, D) for _ in range(3)]
    grads = []
    for plain in (False, True):
        ts = [t.clone().requires_grad_() for t in base]
        fa.reset_counters()
        out = fa.flash_attention(*ts, key_padding_mask=seg, mask_layout="segments", plain=plain)
        (out.float() * w.float()).sum().backward()
        counted = fa.PLAIN_CALLS if plain else fa.LAUNCHES
        assert counted["fa_hm"] == 1 and counted["fa_bwd"] == 1
        grads.append([t.grad.float() for t in ts])
    torch.cuda.synchronize()
    for a, b in zip(*grads):
        assert (a - b).abs().max().item() <= 2 ** -6 * b.abs().max().item()


# B8 sums dq over key tiles by TMA reduce-add (and dk/dv over GQA reps by
# fp32 atomics), in the order blocks finish: two launches may differ by one
# bf16 rounding step of a gradient; with one rep, dk and dv are summed once
# and must be equal
@pytest.mark.parametrize("case", ["causal_leftpad_d96", "gqa_rep7_d128_many_tiles"])
def test_attention_bwd_kernel_repeats_within_one_rounding(gen, case):
    args, kw, _ = _bwd_case(gen, case)
    first = fa.flash_bwd(*args, **kw)
    second = fa.flash_bwd(*args, **kw)
    torch.cuda.synchronize()
    one_rep = args[0].shape[1] == args[1].shape[1]
    for name, a, b in zip(("dq", "dk", "dv"), first, second):
        if one_rep and name != "dq":
            assert torch.equal(a, b), name
            continue
        a, b = a.float(), b.float()
        err = (a - b).abs()
        assert bool((err <= 2 ** -7 * a.abs() + 2 ** -12 * a.abs().max()).all()), (
            f"{name}: max |run 1 - run 2| {err.max().item():.3e}")


@pytest.mark.parametrize("case", ["causal_leftpad_d96", "pad_tile_ragged_d128"])
def test_attention_bwd_kernel_finite_with_g_on_masked_rows(gen, case):
    """g nonzero on fully masked rows: p there is uniform over the keys the
    kernel visits, never NaN, so dq/dk/dv stay finite."""
    args, kw, _ = _bwd_case(gen, case, zero_pad_rows=False)
    for o in fa.flash_bwd(*args, **kw):
        torch.cuda.synchronize()
        assert bool(torch.isfinite(o).all())


def test_attention_functions_run_forward_and_backward_kernels(gen):
    """_FusedCore and _FlashAttentionCore under autograd on the card: the
    kernels in both directions, gradients close to the plain route's."""
    B, S, H, D = 2, 256, 4, 96
    qkv = _randn(gen, B, S, 3 * H * D)
    ang = torch.rand(B, S, D, generator=gen, device="cuda") * 6.3
    cos, sin = ang.cos().bfloat16(), ang.sin().bfloat16()
    mask = torch.ones(B, S, dtype=torch.int32, device="cuda")
    mask[1, :37] = 0
    w = _randn(gen, B, S, H * D) * mask[:, :, None]
    grads = []
    for plain in (False, True):
        x = qkv.clone().requires_grad_()
        fa.reset_counters()
        out = fa.fused_qkv_attention(x, cos, sin, n_heads=H, n_kv_heads=H, head_dim=D,
                                     key_padding_mask=mask, plain=plain)
        (out.float() * w.float()).sum().backward()
        launched = fa.LAUNCHES if not plain else fa.PLAIN_CALLS
        assert launched["fa_bwd"] == 1 and launched["prep"] == 6 and launched["fa_hm"] == 1
        grads.append(x.grad.float())
    torch.cuda.synchronize()
    err = (grads[0] - grads[1]).abs().max().item()
    assert err <= 2 ** -6 * grads[1].abs().max().item(), err
    q, k, v = (_randn(gen, 2, 200, 2, 64).requires_grad_() for _ in range(3))
    fa.reset_counters()
    fa.flash_attention(q, k, v).float().sum().backward()
    assert fa.LAUNCHES["fa_hm"] == 1 and fa.LAUNCHES["fa_bwd"] == 1
    assert all(bool(torch.isfinite(t.grad).all()) for t in (q, k, v))


def test_small_head_dims_run_the_kernels_zero_padded(gen):
    """A tiny config's head_dim 16 runs B3 and B8 at 64, zero-padded, and
    matches the plain route at 16; an fp32 input still raises."""
    q, k, v = (_randn(gen, 2, 256, 2, 16) for _ in range(3))
    mask = torch.ones(2, 256, dtype=torch.int32, device="cuda")
    mask[1, :29] = 0
    g = _randn(gen, 2, 256, 2, 16) * mask[:, :, None, None]
    outs, grads = [], []
    for plain in (False, True):
        ts = [t.clone().requires_grad_() for t in (q, k, v)]
        fa.reset_counters()
        out = fa.flash_attention(*ts, causal=True, key_padding_mask=mask, plain=plain)
        (out.float() * g.float()).sum().backward()
        if not plain:
            assert fa.LAUNCHES["fa_hm"] == 1 and fa.LAUNCHES["fa_bwd"] == 1
        outs.append(out.float())
        grads.append([t.grad.float() for t in ts])
    valid = mask.bool()
    assert outs[0].shape == (2, 256, 2, 16)
    assert ((outs[0] - outs[1]).abs()[valid] <= ATOL + RTOL * outs[1].abs()[valid]).all()
    for a, b in zip(*grads):
        assert (a - b).abs().max().item() <= 2 ** -7 * b.abs().max().item() + 2 ** -8 * \
            b.abs().max().item()
    with pytest.raises(ValueError, match="bf16"):
        fa.flash_attention(q.float(), k.float(), v.float(), causal=True)


def test_raw_launches_refuse_inputs_that_require_grad(gen):
    kv = torch.zeros(1, dtype=torch.int32, device="cuda")
    qkv = _randn(gen, 1, 64, 3 * 2 * 64).requires_grad_()
    hm = _randn(gen, 1, 2, 64, 64).requires_grad_()
    x = _randn(gen, 4, 256).requires_grad_()
    calls = {
        "fa_direct": lambda: fa._launch_fa_direct(qkv, None, None, kv, 2, 64, False, None,
                                                  0.125, 64),
        "prep": lambda: fa._launch_rope_transpose(qkv, None, None, 0, 2, 64),
        "fa_hm": lambda: fa._launch_fa_hm(hm, hm, hm, kv, True, None, 0.125, 64),
        "fa_bwd": lambda: fa._launch_fa_bwd(hm, hm, hm, hm, kv, True, None, 0.125, 64),
        "rms_quant": lambda: qe._launch_rms_quant(x, torch.ones(256, device="cuda"), 1e-5),
        "ln_quant": lambda: qe._launch_ln_quant(
            x.detach(), torch.ones(256, device="cuda", requires_grad=True),
            torch.zeros(256, device="cuda"), 1e-5),
        "silu_mul_quant": lambda: qe._launch_silu_mul_quant(x),
        "row_quant": lambda: qe._launch_row_quant(x),
        "int8_matmul": lambda: im._launch(
            torch.zeros(4, 256, dtype=torch.int8, device="cuda"),
            torch.ones(4, 1, device="cuda", requires_grad=True),
            torch.zeros(256, 128, dtype=torch.int8, device="cuda"),
            torch.ones(1, 128, device="cuda"), torch.bfloat16),
    }
    fa.reset_counters()
    qe.reset_counters()
    im.reset_counters()
    for name, call in calls.items():
        with pytest.raises(RuntimeError, match="cut the gradient"):
            call()
    assert not any(v for d in (fa.LAUNCHES, qe.LAUNCHES, im.LAUNCHES) for v in d.values())


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
        limit = 1e-3 if name in ("rms_quant", "ln_quant") else 0.02
        assert d.max().item() <= 1 and share < limit, share
        assert torch.allclose(a, ra, rtol=2 ** -7, atol=0)
    if name != "ln_quant":  # LayerNorm of a zero row is the bias
        assert float(a[c.shape[0] // 2]) == 1.0 and not bool(c[c.shape[0] // 2].any())


@pytest.mark.parametrize("name", ["rms_quant", "silu_mul_quant", "row_quant", "ln_quant"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_quant_epilogue_kernels_match_plain(gen, name, dtype):
    M, H = 77, 384
    qe.reset_counters()
    if name == "rms_quant":
        x = _rows(gen, M, H, dtype)
        w = torch.randn(H, generator=gen, device="cuda").to(dtype)
        got, ref = qe.rms_quant(x, w, 1e-5), qe.rms_quant_plain(x, w, 1e-5)
    elif name == "ln_quant":
        x = _rows(gen, M, H, dtype)
        w = torch.randn(H, generator=gen, device="cuda").to(dtype)
        b = torch.randn(H, generator=gen, device="cuda").mul_(0.1).to(dtype)
        got, ref = qe.ln_quant(x, w, b, 1e-5), qe.ln_quant_plain(x, w, b, 1e-5)
    elif name == "silu_mul_quant":
        x = _rows(gen, M, 2 * H, dtype)
        got, ref = qe.silu_mul_quant(x), qe.silu_mul_quant_plain(x)
    else:
        x = _rows(gen, M, H, dtype)
        got, ref = qe.row_quant(x), qe.row_quant_plain(x)
    assert qe.LAUNCHES[name] == 1 and qe.PLAIN_CALLS[name] == 1
    torch.cuda.synchronize()
    _check_codes(name, got, ref)


def test_ln_quant_kernel_zero_row_and_leading_axes(gen):
    """B9 at CLIP's width on a (crops, tokens, H) input with an odd row
    count; a zero row under a zero bias takes amax := 1 and zero codes."""
    N, S, H = 3, 37, 1024
    x = _rows(gen, N * S, H, torch.bfloat16).reshape(N, S, H)
    w = torch.randn(H, generator=gen, device="cuda").bfloat16()
    b = torch.zeros(H, device="cuda", dtype=torch.bfloat16)
    codes, amax = qe.ln_quant(x, w, b, 1e-5)
    assert tuple(codes.shape) == (N, S, H) and tuple(amax.shape) == (N, S, 1)
    torch.cuda.synchronize()
    rc, ra = qe.ln_quant_plain(x, w, b, 1e-5)
    _check_codes("ln_quant", (codes.reshape(-1, H), amax.reshape(-1, 1)),
                 (rc.reshape(-1, H), ra.reshape(-1, 1)))
    zero = (N * S) // 2
    assert float(amax.reshape(-1)[zero]) == 1.0 and not bool(codes.reshape(-1, H)[zero].any())


def _norm_quant(kind, gen, M, H, dtype, wdtype=None):
    """(kernel, plain) codes of B4 or B9 on M rows of width H; row M // 2 is
    zero, and with M == 1 the one row is not."""
    wdtype = wdtype or dtype
    x = torch.randn(M, H, generator=gen, device="cuda").mul_(3).to(dtype)
    if M > 1:
        x[M // 2] = 0
    w = torch.randn(H, generator=gen, device="cuda").to(wdtype)
    if kind == "rms_quant":
        return qe.rms_quant(x, w, 1e-5), qe.rms_quant_plain(x, w, 1e-5)
    b = torch.randn(H, generator=gen, device="cuda").mul_(0.1).to(wdtype)
    return qe.ln_quant(x, w, b, 1e-5), qe.ln_quant_plain(x, w, b, 1e-5)


@pytest.mark.parametrize("H", [128, 384, 1024, 3072, 3584, 5120])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("kind", ["rms_quant", "ln_quant"])
def test_streaming_norm_quant_matches_plain_at_every_width(gen, kind, dtype, H):
    """The streaming B4 / B9 at every width a model of the repository runs
    (5120: LLaVA-NeXT-13B), one row, a prime row count no tile height
    divides, and enough rows (10007, prime) that every block walks several
    tiles and the ring and the staging buffers wrap."""
    for M in (1, 131, 10007):
        qe.reset_counters()
        got, ref = _norm_quant(kind, gen, M, H, dtype)
        assert qe.LAUNCHES[kind] == 1
        torch.cuda.synchronize()
        if M > 1:
            _check_codes(kind, got, ref)  # with the zero row
        else:  # the same rule: one code in H may differ by one
            d = (got[0].int() - ref[0].int()).abs()
            assert d.max().item() <= 1 and (d > 0).float().mean().item() < 1e-3
            assert torch.allclose(got[1], ref[1], rtol=2 ** -7, atol=0)


@pytest.mark.parametrize("kind,H", [("rms_quant", 3072), ("rms_quant", 3584), ("ln_quant", 1024)])
def test_norm_quant_reads_bf16_weights_as_their_f32_widening(gen, kind, H):
    """The weight (and bias) are widened in the kernel, exactly: codes from
    bf16 weights equal the codes from the same weights as f32."""
    state = gen.get_state()
    got_bf, _ = _norm_quant(kind, gen, 4099, H, torch.bfloat16, torch.bfloat16)
    gen.set_state(state)
    x = torch.randn(4099, H, generator=gen, device="cuda").mul_(3).bfloat16()
    x[4099 // 2] = 0
    w = torch.randn(H, generator=gen, device="cuda").bfloat16().float()
    if kind == "rms_quant":
        got_f = qe.rms_quant(x, w, 1e-5)
    else:
        b = torch.randn(H, generator=gen, device="cuda").mul_(0.1).bfloat16().float()
        got_f = qe.ln_quant(x, w, b, 1e-5)
    torch.cuda.synchronize()
    assert torch.equal(got_bf[0], got_f[0]) and torch.equal(got_bf[1], got_f[1])


def test_norm_quant_refuses_what_it_does_not_take(gen):
    """Widths the old kernel took (multiples of 8) either run (above) or
    raise ValueError before anything is launched: not a multiple of 16 (the
    bulk copy of a tile's codes), or wider than 5120; so do weights in
    another dtype or on another device (they are never copied)."""
    qe.reset_counters()
    for H in (136, 5376):
        x = _randn(gen, 8, H)
        with pytest.raises(ValueError, match="row width"):
            qe.rms_quant(x, torch.ones(H, device="cuda"))
        with pytest.raises(ValueError, match="row width"):
            qe.ln_quant(x, torch.ones(H, device="cuda"), torch.zeros(H, device="cuda"))
    x = _randn(gen, 8, 1024)
    with pytest.raises(ValueError, match="f32/bf16 tensor"):
        qe.rms_quant(x, torch.ones(1024, device="cuda", dtype=torch.float16))
    with pytest.raises(ValueError, match="f32/bf16 tensor"):
        qe.ln_quant(x, torch.ones(1024, device="cuda"), torch.zeros(1024))
    assert not any(qe.LAUNCHES.values())


# B6's widths on the main paths (PERF.md's B6 row), then widths of its block
# form that are 8 k but not 16 k, or wider than the warp form's 3584; a
# whole row of 58112 (f32: 227 KiB) is read twice, not kept
B6_WIDTHS = [1024, 1536, 1792, 2560, 3072, 3584, 4096, 5120, 6912, 8192, 9472, 13824, 18944]
B6_BLOCK_WIDTHS = [8, 136, 1000, 3592, 5128, 5376, 18952, 58112]


@pytest.mark.parametrize("H", B6_WIDTHS + B6_BLOCK_WIDTHS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_row_quant_modes_match_plain_at_every_width(gen, dtype, H):
    """B6's three modes, each one launch, bit for bit against their plain
    versions: whole rows (codes and amax), the raw absmax, the codes on a
    given amax (each row's absmax times a factor in [1, 2), as another tp
    rank's columns may raise it); on one row, a prime row count that no tile
    height divides and 2053 rows (every ring wraps); row M // 2 zero (amax :=
    1 and zero codes; its raw absmax 0) and row 1 zero on its first half."""
    for M in (1, 131, 2053):
        x = torch.randn(M, H, generator=gen, device="cuda").mul_(3).to(dtype)
        if M > 1:
            x[M // 2] = 0
            x[1, :H // 2] = 0
        qe.reset_counters()
        codes, amax = qe.row_quant(x)
        raw = qe.row_absmax(x)
        given = qe.row_absmax_plain(x) * (1 + torch.rand(M, 1, generator=gen, device="cuda"))
        gcodes, gamax = qe.row_quant(x, given)
        assert qe.LAUNCHES["row_quant"] == 1 and qe.TP_LAUNCHES["row_absmax"] == 1
        assert qe.TP_LAUNCHES["row_quant_given"] == 1
        assert qe.SHAPES == {f"row_quant {H}": 1, f"row_absmax {H}": 1,
                             f"row_quant_given {H}": 1}
        torch.cuda.synchronize()
        rc, ra = qe.row_quant_plain(x)
        assert torch.equal(codes, rc) and torch.equal(amax, ra), (H, M)
        assert torch.equal(raw, qe.row_absmax_plain(x)), (H, M)
        rgc, rga = qe.row_quant_plain(x, given)
        assert torch.equal(gcodes, rgc) and torch.equal(gamax, rga), (H, M)
        if M > 1:
            assert float(raw[M // 2]) == 0.0 and float(amax[M // 2]) == 1.0
            assert float(gamax[M // 2]) == 1.0 and not bool(codes[M // 2].any())


def test_row_quant_refuses_widths_no_form_takes(gen):
    """A width that is not a multiple of 8 raises ValueError in every mode
    before anything is launched."""
    qe.reset_counters()
    for H in (4, 12, 1001):
        x = _randn(gen, 8, H)
        with pytest.raises(ValueError, match="multiple of 8"):
            qe.row_quant(x)
        with pytest.raises(ValueError, match="multiple of 8"):
            qe.row_absmax(x)
        with pytest.raises(ValueError, match="multiple of 8"):
            qe.row_quant(x, torch.ones(8, 1, device="cuda"))
    assert not any(qe.LAUNCHES.values()) and not any(qe.TP_LAUNCHES.values())


@pytest.mark.parametrize("I", [256, 18944])
def test_silu_mul_quant_kernel_at_other_widths(gen, I):
    x = _rows(gen, 40, 2 * I, torch.bfloat16)
    got = qe.silu_mul_quant(x.reshape(2, 20, 2 * I))
    assert tuple(got[0].shape) == (2, 20, I) and tuple(got[1].shape) == (2, 20, 1)
    torch.cuda.synchronize()
    _check_codes("silu_mul_quant", (got[0].reshape(40, I), got[1].reshape(40, 1)),
                 qe.silu_mul_quant_plain(x))


def _k_major_weights(gen, K, N):
    """int8 (K, N) weights laid out as every W8A8 leaf is (``k_major``)."""
    from llava_reward_torch.utils.quantize import k_major

    return k_major(torch.randint(-127, 128, (K, N), generator=gen, device="cuda",
                                 dtype=torch.int8))


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
    wq = _k_major_weights(gen, K, N)
    assert wq.stride() == (1, K)
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


@pytest.mark.parametrize("K", [1792, 13824])
@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("name", ["row_quant", "silu_mul_quant"])
def test_tp_modes_give_the_whole_rows_codes(gen, name, tp, K):
    """A row split over tp ranks: each rank's absmax (B5 / B6's absmax mode),
    the MAX over ranks, then each rank's codes on it (the given-amax mode):
    the kernel's own codes of the whole row, bit for bit; each launch against
    its plain version (B6 bit-exact, B5 under its 2 % rule). K = 1792: qwen's
    o_proj on 2 or 4 ranks, B6's warp form throughout; 13824: LLaVA's
    down_proj, B6's block form on the whole row and on 2 ranks (6912), the
    warp form on 4 (3456)."""
    M = 77
    silu = name == "silu_mul_quant"
    x = _rows(gen, M, 2 * K if silu else K, torch.bfloat16)
    x[3, :K // tp] = 0  # zero on rank 0's columns: its raw absmax is 0
    if silu:
        x[3, K:K + K // tp] = 0
        blocks = [torch.cat([p.chunk(tp, -1)[r] for p in x.chunk(2, -1)], -1).contiguous()
                  for r in range(tp)]
        absmax, quant = qe.silu_mul_absmax, qe.silu_mul_quant
        absmax_plain, quant_plain = qe.silu_mul_absmax_plain, qe.silu_mul_quant_plain
    else:
        blocks = [b.contiguous() for b in x.chunk(tp, -1)]
        absmax, quant, absmax_plain, quant_plain = (qe.row_absmax, qe.row_quant,
                                                    qe.row_absmax_plain, qe.row_quant_plain)
    qe.reset_counters()
    whole = quant(x)
    local = [absmax(b) for b in blocks]
    amax = torch.stack(local).amax(0)
    codes = [quant(b, amax) for b in blocks]
    stem = name[:-len("_quant")]
    assert qe.TP_LAUNCHES == {**dict.fromkeys(qe.TP_NAMES, 0), f"{stem}_absmax": tp,
                              f"{name}_given": tp} and qe.LAUNCHES[name] == 1
    torch.cuda.synchronize()
    assert float(local[0][3]) == 0.0
    assert torch.equal(torch.cat([c for c, _ in codes], -1), whole[0])
    assert all(torch.equal(a, whole[1]) for _, a in codes)
    for b, a, (c, am) in zip(blocks, local, codes):
        ra = absmax_plain(b)
        if silu:
            assert torch.allclose(a, ra, rtol=2 ** -7, atol=0)
        else:
            assert torch.equal(a, ra)
        _check_codes(name, (c, am), quant_plain(b, amax))


@pytest.mark.parametrize("rows", [True, False], ids=["row_block", "column_block"])
def test_int8_matmul_on_a_tp_block_of_a_stacked_leaf(gen, rows):
    """The GEMM on rank r's block of layer 1 of a stacked W8A8 leaf
    (``tp_block``: K-major in storage of its own), bit-exact against its plain
    version; the ranks' row-block products (codes on the tp-global amax) add
    up to the whole leaf's within two fp32 roundings, their column blocks
    are its columns exactly (the fused [q | k | v] parts' r-th slices)."""
    from llava_reward_torch.utils.quantize import quantize_stacked_layers, tp_block

    K, N, tp, M = 1792, 1152, 2, 100
    parts = (768, 192, 192)
    w = torch.randn(2, K, N, generator=gen, device="cuda").mul_(0.02).bfloat16()
    leaf = quantize_stacked_layers({"w": w}, min_size=0, scheme="w8a8")["w"]
    x = _rows(gen, M, K, torch.bfloat16)
    whole = im.w8a8_matmul(x, leaf["qvalues_w8a8"][1], leaf["scale"][1], torch.float32)
    outs = []
    for r in range(tp):
        blk = tp_block(leaf, rows, parts, tp, r)
        wq, ws = blk["qvalues_w8a8"][1], blk["scale"][1]
        assert wq.stride() == (1, wq.shape[0])
        if rows:
            xr = x.chunk(tp, -1)[r].contiguous()
            amax = torch.stack([qe.row_absmax(b.contiguous()) for b in x.chunk(tp, -1)]).amax(0)
            got = im.w8a8_matmul(xr, wq, ws, torch.float32, amax)
            ref = im.w8a8_matmul_plain(xr, wq, ws, torch.float32, amax)
        else:
            got = im.w8a8_matmul(x, wq, ws, torch.float32)
            ref = im.w8a8_matmul_plain(x, wq, ws, torch.float32)
        torch.cuda.synchronize()
        assert torch.equal(got, ref)
        outs.append(got)
    if rows:
        total = sum(outs)
        assert ((total - whole).abs() <= 2 * 2 ** -23 * (outs[0].abs() + outs[1].abs())
                + 2 ** -23 * whole.abs()).all()
    else:
        pieces = [o.split([p // tp for p in parts], -1) for o in outs]
        back = torch.cat([torch.cat([p[j] for p in pieces], -1) for j in range(len(parts))], -1)
        assert torch.equal(back, whole)


def test_int4_runs_as_w8a8_through_the_gemm(gen):
    """Packed int4 leaves unpack in dequant_layer into K-major W8A8 codes,
    which the GEMM takes bit-exact against its plain version."""
    from llava_reward_torch.utils.quantize import dequant_layer, qmatmul, quantize_stacked_layers

    w = torch.randn(2, 512, 384, generator=gen, device="cuda").mul_(0.02).bfloat16()
    packed = quantize_stacked_layers({"w": w}, bits=4, min_size=0)["w"]
    leaf = dequant_layer({"w": {k: v[1] for k, v in packed.items()}})["w"]
    assert leaf["qvalues_w8a8"].shape == (512, 384) and leaf["qvalues_w8a8"].stride() == (1, 512)
    x = _rows(gen, 70, 512, torch.bfloat16)
    im.reset_counters()
    got = qmatmul(x, leaf)
    assert im.LAUNCHES["int8_matmul"] == 1
    ref = qmatmul(x, leaf, plain=True)
    torch.cuda.synchronize()
    assert torch.equal(got, ref)


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


@pytest.mark.parametrize("K,N", [(5120, 5120), (13824, 5120)], ids=["q_proj", "down_proj"])
def test_int8_linear_core_forward_and_backward_on_the_card(gen, K, N):
    """``_Int8LinearCore`` (the W8A8 projection under LoRA) at LLaVA-NeXT-13B
    projections' shapes and a B=2 training batch's rows: the forward through
    B6 + the GEMM bit-equal to the plain versions', and the backward (bf16
    operands, an fp32 result on the tensor cores, rounded once to bf16)
    within one bf16 ulp of the fp32 product of the same operands, plus the
    two fp32 summation orders' difference."""
    from llava_reward_torch.utils.quantize import W8A8_KEY, int8_linear, quantize_array_w8a8

    M = 2 * 2976
    qd = quantize_array_w8a8(torch.randn(K, N, generator=gen, device="cuda") * 0.02)
    x = _randn(gen, M, K)
    dy = _randn(gen, M, N)
    xk, xp = x.clone().requires_grad_(), x.clone().requires_grad_()
    qe.reset_counters()
    im.reset_counters()
    yk, yp = int8_linear(xk, qd), int8_linear(xp, qd, plain=True)
    assert qe.LAUNCHES["row_quant"] == 1 and im.LAUNCHES["int8_matmul"] == 1
    (dxk,) = torch.autograd.grad(yk, [xk], dy)
    (dxp,) = torch.autograd.grad(yp, [xp], dy)
    torch.cuda.synchronize()
    assert torch.equal(yk, yp) and torch.equal(dxk, dxp) and dxk.dtype == torch.bfloat16
    dys = (dy.float() * qd["scale"]).to(torch.bfloat16).float()
    wf = qd[W8A8_KEY].float()
    ref = (dys @ wf.t()).to(torch.bfloat16).float()
    # one bf16 ulp, plus fp32 summation-order noise: 2^-16 of the sum of the
    # terms' magnitudes (bf16 partial sums would read ~2^-9 of it)
    bound = ref.abs() * 2.0 ** -7 + (dys.abs() @ wf.abs().t()) * 2.0 ** -16
    assert bool(((dxk.float() - ref).abs() <= bound).all())


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
    with pytest.raises(ValueError, match="K-major"):  # (K, N) row-major: N contiguous
        im.int8_matmul_pre(codes[:, :192].contiguous(), amax,
                           torch.zeros(192, 64, dtype=torch.int8, device="cuda"),
                           torch.ones(1, 64, device="cuda"))
    attn = _randn(gen, 2, 64, 4, 128).transpose(1, 2)  # (B, H, S, D): not a row layout
    with pytest.raises(ValueError, match="not contiguous"):
        qe.row_quant(attn.reshape(2, 4, 64 * 128)[:, :, :256])
    with pytest.raises(ValueError, match="not contiguous"):
        qe.row_quant(attn)
    x = _randn(gen, 8, 1024)
    with pytest.raises(ValueError, match="weight and bias"):
        qe.ln_quant(x, torch.ones(1024, device="cuda"), torch.zeros(512, device="cuda"))
    with pytest.raises(ValueError, match="f32/bf16"):
        qe.ln_quant(x.half(), torch.ones(1024, device="cuda"), torch.zeros(1024, device="cuda"))
