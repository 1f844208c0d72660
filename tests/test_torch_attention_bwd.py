"""The attention backward (B8) of the port against the JAX package's, on the
CPU.

- ``flash_bwd_plain`` against ``_flash_bwd`` called directly, which runs the
  Pallas ``_fa_bwd_kernel`` interpreted (as tests/test_flash_attention.py
  runs the kernels). Lane-aligned shapes (D 64 / 96 / 128, S a multiple of
  the JAX kernel's q block): causal with left pad and g zeroed on the fully
  masked rows, as on the training path; non-causal with a ragged ``q_len``
  tail (keys past it masked); GQA with n_rep 2; a sliding window. fp32 to
  TOL_F32 (two summation orders), and one bf16 case to TOL_BF16: the JAX
  kernel rounds each causal q block's partial dk/dv to bf16 before summing
  them, the port rounds once.
- The port's ``fused_qkv_attention`` (``_FusedCore``) and ``flash_attention``
  (``_FlashAttentionCore``) under ``torch.autograd``, on CPU tensors (so the
  plain versions run), against ``jax.value_and_grad`` of
  ``fused_rope_attention(impl="pallas")`` and ``flash_attention`` (the
  interpreted kernels), in fp32 to TOL_F32.
- B8's key-mask and segment-id modes (``MASK_BWD_CASES``; head_dim 80 is
  Qwen2.5-VL's vision head, which the JAX kernel pads to 128 lanes and the
  port does not), g NOT zeroed on pad queries where every key tile is visited
  (non-causal): dq is compared on the query rows that have a key, dk and dv
  on every valid key, so a pad query (uniform p from the -1e30 fill) leaking
  into a valid key's dk/dv differently from the JAX kernel would show. S is
  one JAX q block (256), so both weigh a pad query's keys by 1/S.
- ``flash_attention(mask_layout="segments" | "arbitrary")`` gradients against
  ``jax.grad`` of the JAX entry.
- The raw launches refuse a grad-requiring input.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llava_reward_tpu.ops import attention as jatt
from llava_reward_tpu.ops import flash_attention as jfa
from llava_reward_tpu.ops.rope import compute_rope_cos_sin as j_cos_sin
from llava_reward_torch.ops import attention as tatt
from llava_reward_torch.ops import cuda_lib
from llava_reward_torch.ops import flash_attention as tfa

TOL_F32 = 2e-5  # fp32: the same sums in another order
TOL_BF16 = 2 ** -6  # of max|grad|: bf16 roundings at other points (see above)


def _np(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


BWD_CASES = {
    # name: (B, S, H, Hk, D, causal, kv_start, q_len, window)
    "causal_leftpad_d96": (2, 256, 4, 4, 96, True, [0, 37], 256, None),
    "noncausal_qlen_tail_d64": (2, 256, 2, 2, 64, False, [0, 0], 200, None),
    "gqa_rep2_causal_d64": (2, 256, 4, 2, 64, True, [5, 0], 256, None),
    "window_leftpad_d128": (1, 256, 2, 2, 128, True, [19], 256, 48),
}


def _bwd_inputs(case, seed=0):
    B, S, H, Hk, D, causal, kv_start, q_len, window = BWD_CASES[case]
    rng = np.random.default_rng(seed)
    q, g = _np(rng, B, S, H, D), _np(rng, B, S, H, D)
    k, v = _np(rng, B, S, Hk, D), _np(rng, B, S, Hk, D)
    # the path's g: zero on fully masked (left-pad) query rows and past q_len
    rows = np.arange(S)[None, :]
    live = (rows >= np.asarray(kv_start)[:, None]) if causal else (rows < q_len)
    g = g * live[:, :, None, None]
    return (q, k, v, g), (kv_start, q_len, causal, window, D ** -0.5)


def _jax_bwd(q, k, v, g, kv_start, q_len, causal, window, scale):
    """``_flash_bwd`` at S = q_len: it masks keys at or past its S, so the
    ragged tail is a shorter call, and its rows past q_len are zero."""
    S = q.shape[1]
    cut = lambda x: jnp.asarray(x[:, :q_len])  # noqa: E731
    out = jfa._flash_bwd(cut(q), cut(k), cut(v), cut(g), jnp.asarray(kv_start, jnp.int32),
                         None, causal, window, scale)
    pad = [(0, 0), (0, S - q_len), (0, 0), (0, 0)]
    return [np.pad(np.asarray(o, np.float32), pad) for o in out]


def _torch_bwd(q, k, v, g, kv_start, q_len, causal, window, scale, dtype=torch.float32):
    hm = lambda x: torch.from_numpy(x).to(dtype).transpose(1, 2)  # noqa: E731
    out = tfa.flash_bwd(hm(q), hm(k), hm(v), hm(g), torch.tensor(kv_start, dtype=torch.int32),
                        causal=causal, sliding_window=window, scale=scale, q_len=q_len)
    return [o.transpose(1, 2).float().numpy() for o in out]


@pytest.mark.parametrize("case", sorted(BWD_CASES))
def test_plain_bwd_matches_interpreted_pallas_f32(case):
    arrays, (kv_start, q_len, causal, window, scale) = _bwd_inputs(case)
    tfa.reset_counters()
    got = _torch_bwd(*arrays, kv_start, q_len, causal, window, scale)
    assert tfa.PLAIN_CALLS["fa_bwd"] == 1 and tfa.LAUNCHES["fa_bwd"] == 0
    ref = _jax_bwd(*arrays, kv_start, q_len, causal, window, scale)
    for name, t, j in zip("qkv", got, ref):
        assert np.isfinite(t).all(), name
        # rows past q_len: the JAX call never sees them
        np.testing.assert_allclose(t[:, :q_len], j[:, :q_len], rtol=TOL_F32, atol=TOL_F32,
                                   err_msg=f"d{name}")


def test_plain_bwd_matches_interpreted_pallas_bf16():
    arrays, (kv_start, q_len, causal, window, scale) = _bwd_inputs("causal_leftpad_d96", 1)
    bf = [np.asarray(jnp.asarray(a, jnp.bfloat16)) for a in arrays]
    got = _torch_bwd(*[a.astype(np.float32) for a in bf], kv_start, q_len, causal, window,
                     scale, dtype=torch.bfloat16)
    ref = _jax_bwd(*bf, kv_start, q_len, causal, window, scale)
    for name, t, j in zip("qkv", got, ref):
        assert np.abs(t - j).max() <= TOL_BF16 * np.abs(j).max(), f"d{name}"


def test_plain_bwd_fully_masked_rows_stay_finite_with_nonzero_g():
    """A left-pad row's scores are all -1e30: p must come out uniform, not
    NaN, or 0 * NaN would poison dk/dv for every key."""
    arrays, (kv_start, q_len, causal, window, scale) = _bwd_inputs("causal_leftpad_d96")
    q, k, v, _ = arrays
    g = _np(np.random.default_rng(9), *q.shape)  # nonzero on the pad rows too
    for out in _torch_bwd(q, k, v, g, kv_start, q_len, causal, window, scale):
        assert np.isfinite(out).all()


def _mask_rows(B, S, rng, n_seg):
    """(B, S) int32 segment ids in ``n_seg`` runs; from batch row 1 on, pad
    slots (0) interleaved in runs of 4 to 12, as windowized images leave them."""
    rows = np.zeros((B, S), np.int32)
    for b in range(B):
        cuts = np.sort(rng.choice(np.arange(1, S), n_seg - 1, replace=False))
        for i, (lo, hi) in enumerate(zip([0, *cuts], [*cuts, S])):
            rows[b, lo:hi] = i + 1
        if b > 0:
            for start in rng.choice(S - 12, 4, replace=False):
                rows[b, start : start + rng.integers(4, 13)] = 0
    return rows


def _allowed(rows, seg, causal, window):
    """(B, query, key) bool: which keys count for which queries."""
    S = rows.shape[1]
    ok = np.broadcast_to((rows != 0)[:, None, :], (rows.shape[0], S, S)).copy()
    if seg:
        ok &= rows[:, None, :] == rows[:, :, None]
    pos = np.arange(S)
    if causal:
        ok &= pos[None, None, :] <= pos[None, :, None]
        if window is not None:
            ok &= pos[None, None, :] > pos[None, :, None] - window
    return ok


MASK_BWD_CASES = {
    # name: (B, S, H, Hk, D, causal, window, layout, segments per row)
    "segments_d80_pads": (2, 256, 2, 2, 80, False, None, "segments", 1),
    "segments_frames_gqa_d64": (2, 256, 4, 2, 64, False, None, "segments", 3),
    "key_mask_d80_pads": (2, 256, 2, 2, 80, False, None, "arbitrary", 1),
    "key_mask_gqa_d128": (2, 256, 4, 1, 128, False, None, "arbitrary", 1),
    "key_mask_causal_window_d96": (2, 256, 4, 4, 96, True, 40, "arbitrary", 1),
}


def _mask_bwd_inputs(case):
    B, S, H, Hk, D, causal, window, layout, n_seg = MASK_BWD_CASES[case]
    rng = np.random.default_rng(21)
    q, g = _np(rng, B, S, H, D), _np(rng, B, S, H, D)
    k, v = _np(rng, B, S, Hk, D), _np(rng, B, S, Hk, D)
    rows = _mask_rows(B, S, rng, n_seg)
    seg = layout == "segments"
    mask = rows if seg else (rows != 0).astype(np.int32)
    has_key = _allowed(rows, seg, causal, window).any(-1)  # (B, S) queries with a key
    if causal:  # tile skipping: a keyless row's p depends on the keys visited
        g = g * has_key[:, :, None, None]
    return (q, k, v, g), mask, has_key, rows != 0, (causal, window, D ** -0.5, seg)


@pytest.mark.parametrize("case", sorted(MASK_BWD_CASES))
def test_plain_bwd_mask_modes_match_interpreted_pallas(case):
    (q, k, v, g), mask, has_key, key_valid, (causal, window, scale, seg) = _mask_bwd_inputs(case)
    B, S = mask.shape
    if seg:
        assert not has_key.all()  # pad queries with g != 0 are in the case
    kv0 = np.zeros(B, np.int32)
    ref = jfa._flash_bwd(*map(jnp.asarray, (q, k, v, g)), jnp.asarray(kv0), jnp.asarray(mask),
                         causal, window, scale, segments=seg)
    hm = lambda x: torch.from_numpy(x).transpose(1, 2)  # noqa: E731
    tfa.reset_counters()
    got = tfa.flash_bwd(hm(q), hm(k), hm(v), hm(g), torch.from_numpy(kv0), causal=causal,
                        sliding_window=window, scale=scale, q_len=S,
                        key_mask=torch.from_numpy(mask), segments=seg)
    assert tfa.PLAIN_CALLS["fa_bwd"] == 1 and tfa.LAUNCHES["fa_bwd"] == 0
    for name, t, j, rows in zip("qkv", got, ref, (has_key, key_valid, key_valid)):
        t, j = t.transpose(1, 2).numpy(), np.asarray(j)
        assert np.isfinite(t).all(), name
        np.testing.assert_allclose(t[rows], j[rows], rtol=TOL_F32, atol=TOL_F32,
                                   err_msg=f"d{name}")


def test_plain_bwd_segment_pad_queries_stay_finite_with_nonzero_g():
    """A pad patch (segment id 0) has no key: its p is uniform from the
    -1e30 fill, never NaN, also in a row that is all pad."""
    rng = np.random.default_rng(22)
    B, S, H, D = 2, 128, 2, 80
    q, k, v, g = (torch.from_numpy(_np(rng, B, H, S, D)) for _ in range(4))
    seg = torch.from_numpy(_mask_rows(B, S, rng, 2))
    seg[0] = 0
    out = tfa.flash_bwd(q, k, v, g, torch.zeros(B, dtype=torch.int32), causal=False,
                        sliding_window=None, scale=D ** -0.5, q_len=S, key_mask=seg,
                        segments=True)
    assert all(bool(torch.isfinite(o).all()) for o in out)


@pytest.mark.parametrize("layout", ["segments", "arbitrary"])
def test_flash_attention_mask_layout_grads_match_jax(layout):
    """``_FlashAttentionCore`` in the segment and key-mask modes (forward B3,
    backward B8) against ``jax.value_and_grad`` of the JAX ``flash_attention``,
    at Qwen2.5-VL's vision head_dim."""
    B, S, H, D = 2, 256, 2, 80
    rng = np.random.default_rng(23)
    q, k, v, w = (_np(rng, B, S, H, D) for _ in range(4))
    rows = _mask_rows(B, S, rng, 2 if layout == "segments" else 1)
    mask = rows if layout == "segments" else (rows != 0).astype(np.int32)
    if layout == "segments":
        w = w * (rows != 0)[:, :, None, None]  # a pad query's output is not part of the loss

    def jloss(q_, k_, v_):
        out = jfa.flash_attention(q_, k_, v_, key_padding_mask=jnp.asarray(mask),
                                  mask_layout=layout)
        return jnp.sum(out * w)

    jval, jgrads = jax.value_and_grad(jloss, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    ts = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    tfa.reset_counters()
    out = tfa.flash_attention(*ts, key_padding_mask=torch.from_numpy(mask), mask_layout=layout)
    tval = (out * torch.from_numpy(w)).sum()
    tval.backward()
    assert tfa.PLAIN_CALLS["fa_hm"] == 1 and tfa.PLAIN_CALLS["fa_bwd"] == 1
    np.testing.assert_allclose(tval.item(), float(jval), rtol=TOL_F32)
    valid = rows != 0
    for name, t, j in zip("qkv", ts, jgrads):
        np.testing.assert_allclose(t.grad.numpy()[valid], np.asarray(j)[valid], rtol=TOL_F32,
                                   atol=TOL_F32, err_msg=f"d{name}")


def _rope_tables(B, S, D):
    pos = jnp.broadcast_to(jnp.arange(S)[None], (B, S))
    return j_cos_sin(pos, D, dtype=jnp.float32)


FUSED_CASES = {
    # name: (B, S, H, Hk, D, pads)
    "mha_d96_leftpad": (2, 256, 4, 4, 96, [0, 29]),
    "gqa_d64_leftpad": (1, 256, 4, 2, 64, [9]),
    "end_padded_s200": (2, 200, 2, 2, 64, [0, 13]),
}


@pytest.mark.parametrize("case", sorted(FUSED_CASES))
def test_fused_qkv_attention_grad_matches_jax(case):
    """``_FusedCore`` (forward B2 x3 + B3, backward B2 x3 + B8 + the RoPE VJP)
    against ``jax.value_and_grad`` of ``fused_rope_attention(impl="pallas")``."""
    B, S, H, Hk, D, pads = FUSED_CASES[case]
    rng = np.random.default_rng(2)
    qkv = _np(rng, B, S, (H + 2 * Hk) * D)
    cos, sin = _rope_tables(B, S, D)
    mask = np.ones((B, S), np.int32)
    for i, p in enumerate(pads):
        mask[i, :p] = 0
    w = mask.astype(np.float32)[:, :, None] * _np(rng, B, S, H * D)
    kw = dict(n_heads=H, n_kv_heads=Hk, head_dim=D, causal=True)

    def jloss(x):
        out = jatt.fused_rope_attention(x, cos, sin, key_padding_mask=jnp.asarray(mask),
                                        impl="pallas", **kw)
        return jnp.sum(out * w)

    jval, jgrad = jax.value_and_grad(jloss)(jnp.asarray(qkv))

    x = torch.from_numpy(qkv).requires_grad_()
    tfa.reset_counters()
    out = tatt.fused_rope_attention(x, torch.from_numpy(np.array(cos)),
                                    torch.from_numpy(np.array(sin)),
                                    key_padding_mask=torch.from_numpy(mask), impl="pallas", **kw)
    tval = (out * torch.from_numpy(w)).sum()
    tval.backward()
    assert tfa.PLAIN_CALLS["fa_bwd"] == 1 and tfa.PLAIN_CALLS["prep"] == 6
    np.testing.assert_allclose(tval.item(), float(jval), rtol=TOL_F32)
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(jgrad), rtol=TOL_F32, atol=TOL_F32)


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "noncausal"])
def test_flash_attention_grad_matches_jax(causal):
    """``_FlashAttentionCore`` (forward B3, backward B8) against
    ``jax.value_and_grad`` of the JAX ``flash_attention`` entry; S = 200 is
    not a multiple of the 64-row tile (the CLIP tower's case)."""
    B, S, H, D = 2, 200, 2, 64
    rng = np.random.default_rng(3)
    q, k, v, w = (_np(rng, B, S, H, D) for _ in range(4))
    mask = np.ones((B, S), np.int32)
    mask[1, :11] = 0
    if causal:
        w[1, :11] = 0.0

    def jloss(q_, k_, v_):
        out = jfa.flash_attention(q_, k_, v_, causal=causal, key_padding_mask=jnp.asarray(mask))
        return jnp.sum(out * w)

    jval, jgrads = jax.value_and_grad(jloss, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    ts = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    tfa.reset_counters()
    out = tfa.flash_attention(*ts, causal=causal, key_padding_mask=torch.from_numpy(mask))
    tval = (out * torch.from_numpy(w)).sum()
    tval.backward()
    assert tfa.PLAIN_CALLS["fa_hm"] == 1 and tfa.PLAIN_CALLS["fa_bwd"] == 1
    np.testing.assert_allclose(tval.item(), float(jval), rtol=TOL_F32)
    for t, j in zip(ts, jgrads):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(j), rtol=TOL_F32, atol=TOL_F32)


def test_refuse_grad_names_the_function():
    x = torch.zeros(2, requires_grad=True)
    with pytest.raises(RuntimeError, match="_FusedCore"):
        cuda_lib.refuse_grad("prep", x, None, route="route it through _FusedCore")
    with torch.no_grad():
        cuda_lib.refuse_grad("prep", x, route="no grad: nothing to cut")
    cuda_lib.refuse_grad("prep", x.detach(), route="no input requires grad")
