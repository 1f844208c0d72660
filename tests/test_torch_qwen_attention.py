"""B3's key-mask and segment-id modes (Qwen2.5-VL's vision tower): the
port's plain versions against the JAX package's Pallas kernel run
interpreted on the CPU, fp32 from a numpy seed.

Valid rows must agree to 2e-5 (fp32, two summation orders). A query row
whose keys are all masked (a pad patch: segment id 0) is finite in both,
but its value depends on the keys a kernel visits, so it is only required
to be finite. head_dim 80 is Qwen's vision head (1280 / 16).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from llava_reward_tpu.ops import attention as jatt
from llava_reward_tpu.ops import flash_attention as jfa
from llava_reward_torch.ops import attention as tatt
from llava_reward_torch.ops import flash_attention as tfa

TOL = 2e-5


def _np(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def segment_rows(B, S, rng, n_seg=1, pads=True):
    """(B, S) int32 segment ids: ``n_seg`` runs, pad slots (0) interleaved
    in runs of 4 to 12 as windowized images leave them, one row all valid."""
    rows = np.zeros((B, S), np.int32)
    for b in range(B):
        cuts = np.sort(rng.choice(np.arange(1, S), n_seg - 1, replace=False))
        seg = np.zeros(S, np.int32)
        for i, (lo, hi) in enumerate(zip([0, *cuts], [*cuts, S])):
            seg[lo:hi] = i + 1
        if pads and b > 0:
            for start in rng.choice(S - 12, 4, replace=False):
                seg[start : start + rng.integers(4, 13)] = 0
        rows[b] = seg
    return rows


HM_CASES = {
    # name: (B, H, Hk, S, D, causal, window, mode, n_seg)
    "segments_d80_pads": (3, 2, 2, 192, 80, False, None, "segments", 1),
    "segments_d80_frames": (2, 2, 2, 256, 80, False, None, "segments", 3),
    "segments_gqa_d64": (2, 4, 2, 128, 64, False, None, "segments", 2),
    "key_mask_d80_pads": (3, 2, 2, 128, 80, False, None, "arbitrary", 1),
    "key_mask_causal_window_d96": (2, 4, 4, 128, 96, True, 40, "arbitrary", 1),
}


@pytest.mark.parametrize("case", sorted(HM_CASES))
def test_masked_head_major_kernel_matches_pallas(case):
    B, H, Hk, S, D, causal, window, mode, n_seg = HM_CASES[case]
    rng = np.random.default_rng(11)
    qt, kt, vt = _np(rng, B, H, S, D), _np(rng, B, Hk, S, D), _np(rng, B, Hk, S, D)
    rows = segment_rows(B, S, rng, n_seg)
    seg = mode == "segments"
    key_mask = rows if seg else (rows != 0).astype(np.int32)
    kv0 = np.zeros(B, np.int32)
    ref = jfa._flash_fwd_hm(
        jnp.asarray(qt), jnp.asarray(kt), jnp.asarray(vt), jnp.asarray(kv0),
        jnp.asarray(key_mask), causal, window, D ** -0.5, q_len=S, block_q=64, segments=seg,
    )
    tfa.reset_counters()
    out = tfa._flash_fwd_hm(_t(qt), _t(kt), _t(vt), _t(kv0), _t(key_mask), causal, window,
                            D ** -0.5, q_len=S, segments=seg).numpy()
    assert tfa.PLAIN_CALLS["fa_hm"] == 1 and not any(tfa.LAUNCHES.values())
    valid = rows != 0 if seg else np.ones((B, S), bool)  # a pad query has no key
    o, r = out.transpose(0, 2, 1, 3), np.asarray(ref).transpose(0, 2, 1, 3)
    np.testing.assert_allclose(o[valid], r[valid], rtol=TOL, atol=TOL)
    assert np.isfinite(out).all()


@pytest.mark.parametrize("layout", ["segments", "arbitrary"])
def test_flash_attention_mask_layouts_match_jax(layout):
    """The (B, S, H, D) entry with ``mask_layout`` "segments" / "arbitrary",
    through ``mha(impl="pallas")`` (the vision tower's full and window
    blocks), against the JAX entry and the reference attention."""
    rng = np.random.default_rng(12)
    B, S, H, D = 2, 128, 2, 80
    q, k, v = (_np(rng, B, S, H, D) for _ in range(3))
    rows = segment_rows(B, S, rng, 2 if layout == "segments" else 1)
    mask = rows if layout == "segments" else (rows != 0).astype(np.int32)
    kw = dict(causal=False, key_padding_mask=None, mask_layout=layout)
    ref = jatt.mha(*map(jnp.asarray, (q, k, v)), impl="pallas",
                   **{**kw, "key_padding_mask": jnp.asarray(mask)})
    xla = jatt.mha(*map(jnp.asarray, (q, k, v)), impl="xla",
                   **{**kw, "key_padding_mask": jnp.asarray(mask)})
    tfa.reset_counters()
    got = tatt.mha(*map(_t, (q, k, v)), impl="pallas", **{**kw, "key_padding_mask": _t(mask)})
    assert tfa.PLAIN_CALLS["fa_hm"] == 1
    plain = tatt.mha(*map(_t, (q, k, v)), impl="xla", **{**kw, "key_padding_mask": _t(mask)})
    valid = rows != 0 if layout == "segments" else np.ones((B, S), bool)
    np.testing.assert_allclose(got.numpy()[valid], np.asarray(ref)[valid], rtol=TOL, atol=TOL)
    np.testing.assert_allclose(plain.numpy()[valid], np.asarray(xla)[valid], rtol=TOL, atol=TOL)
    np.testing.assert_allclose(got.numpy()[valid], plain.numpy()[valid], rtol=1e-4, atol=1e-4)
    assert np.isfinite(got.numpy()).all()


def test_fully_masked_rows_are_finite():
    """A row whose every key is masked (a pad window, a pad query) comes out
    finite: the -1e30 fill, not -inf."""
    rng = np.random.default_rng(13)
    B, H, S, D = 2, 2, 64, 80
    qt, kt, vt = (_t(_np(rng, B, H, S, D)) for _ in range(3))
    kv0 = torch.zeros(B, dtype=torch.int32)
    key_mask = torch.zeros(B, S, dtype=torch.int32)
    key_mask[1, 5:9] = 1
    for seg in (False, True):
        out = tfa._flash_fwd_hm(qt, kt, vt, kv0, key_mask, False, None, D ** -0.5, q_len=S,
                                segments=seg)
        assert bool(torch.isfinite(out).all())


def test_masked_modes_have_a_backward():
    """The segment and key-mask layouts are differentiable like the left-pad
    one (their gradients are held to JAX's in
    tests/test_torch_attention_bwd.py), and an unknown layout raises."""
    rng = np.random.default_rng(14)
    q, k, v = (_t(_np(rng, 1, 64, 2, 64)).requires_grad_() for _ in range(3))
    mask = torch.ones(1, 64, dtype=torch.int32)
    mask[0, 7:19] = 0
    for layout in ("segments", "arbitrary", "leftpad"):
        tfa.reset_counters()
        m = mask if layout != "leftpad" else torch.ones_like(mask)
        tfa.flash_attention(q, k, v, key_padding_mask=m, mask_layout=layout).sum().backward()
        assert tfa.PLAIN_CALLS["fa_bwd"] == 1
        for t in (q, k, v):
            assert t.grad is not None and bool(torch.isfinite(t.grad).all())
            t.grad = None
    with pytest.raises(ValueError, match="mask_layout"):
        tfa.flash_attention(q, k, v, key_padding_mask=mask, mask_layout="ragged")
