"""The port's attention kernels (plain versions on the CPU) against the JAX
package's Pallas kernels, run interpreted on the CPU as
tests/test_flash_attention.py runs them.

Shapes reach the Pallas entries directly: head groups whose width g*D is a
multiple of 128 (4 heads x 96, 2 heads x 64), S <= 256. Inputs are fp32
from a numpy seed. Valid rows must agree to 2e-5 (fp32, two summation
orders); pad rows (left-pad queries, rows past valid_len) depend on the
keys a kernel visits, so they are only required to be finite.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from llava_reward_tpu.ops import flash_attention as jfa
from llava_reward_tpu.ops.rope import compute_rope_cos_sin as j_cos_sin
from llava_reward_torch.ops import attention as tatt
from llava_reward_torch.ops import flash_attention as tfa

TOL = 2e-5


def _np(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _cos_sin(B, S, D):
    pos = jnp.broadcast_to(jnp.arange(S)[None], (B, S))
    c, s = j_cos_sin(pos, D, dtype=jnp.float32)
    return np.asarray(c), np.asarray(s)


def _t(x):
    return torch.from_numpy(np.array(x))


def _valid_rows(B, S, kv_start, q_len):
    rows = np.arange(S)[None, :]
    return (rows >= np.asarray(kv_start)[:, None]) & (rows < q_len)


DIRECT_CASES = {
    # name: (H, D, causal, rope, kv_start, valid_len, window)
    "decoder_causal_rope_leftpad": (4, 96, True, True, [0, 37], None, None),
    "clip_full_valid_len": (2, 64, False, False, [0, 0], 200, None),
    "causal_window_leftpad": (4, 96, True, True, [70, 3], None, 40),
}


@pytest.mark.parametrize("case", sorted(DIRECT_CASES))
def test_direct_kernel_matches_pallas(case):
    H, D, causal, rope, kv_start, valid_len, window = DIRECT_CASES[case]
    rng = np.random.default_rng(1)
    B, S = 2, 256
    qkv = _np(rng, B, S, 3 * H * D)
    cos, sin = _cos_sin(B, S, D) if rope else (None, None)
    kw = dict(n_heads=H, head_dim=D, causal=causal, sliding_window=window,
              scale=D ** -0.5, valid_len=valid_len)
    ref = jfa._fused_qkv_attention_direct(
        jnp.asarray(qkv), None if cos is None else jnp.asarray(cos),
        None if sin is None else jnp.asarray(sin), jnp.asarray(kv_start, jnp.int32), **kw,
    )
    before = tfa.PLAIN_CALLS["fa_direct"]
    out = tfa._fused_qkv_attention_direct(
        _t(qkv), None if cos is None else _t(cos), None if sin is None else _t(sin),
        torch.tensor(kv_start, dtype=torch.int32), **kw,
    ).numpy()
    assert tfa.PLAIN_CALLS["fa_direct"] == before + 1
    valid = _valid_rows(B, S, kv_start, valid_len or S)
    np.testing.assert_allclose(out[valid], np.asarray(ref)[valid], rtol=TOL, atol=TOL)
    assert np.isfinite(out).all()


@pytest.mark.parametrize("part", ["q", "k", "v"])
def test_rope_transpose_matches_pallas(part):
    rng = np.random.default_rng(2)
    B, S, H, D = 2, 256, 4, 96
    x = _np(rng, B, S, 3 * H * D)
    cos, sin = _cos_sin(B, S, D)
    off = {"q": 0, "k": H * D, "v": 2 * H * D}[part]
    rope = part != "v"
    ref = jfa.rope_transpose(
        jnp.asarray(x), jnp.asarray(cos) if rope else None,
        jnp.asarray(sin) if rope else None, col_offset=off, n_heads=H, head_dim=D,
    )
    out = tfa.rope_transpose(
        _t(x), _t(cos) if rope else None, _t(sin) if rope else None,
        col_offset=off, n_heads=H, head_dim=D,
    ).numpy()
    assert out.shape == (B, H, S, D)
    np.testing.assert_allclose(out, np.asarray(ref), rtol=1e-6, atol=1e-6)


HM_CASES = {
    # name: (H, Hk, D, causal, kv_start, q_len, window)
    "causal_leftpad": (4, 4, 96, True, [0, 51], 256, None),
    "full_q_len_tail": (2, 2, 64, False, [0, 0], 190, None),
    "causal_window": (4, 4, 96, True, [10, 0], 256, 33),
    "gqa_causal_leftpad": (4, 2, 64, True, [5, 64], 256, None),
}


@pytest.mark.parametrize("case", sorted(HM_CASES))
def test_head_major_kernel_matches_pallas(case):
    H, Hk, D, causal, kv_start, q_len, window = HM_CASES[case]
    rng = np.random.default_rng(3)
    B, S = 2, 256
    qt, kt, vt = _np(rng, B, H, S, D), _np(rng, B, Hk, S, D), _np(rng, B, Hk, S, D)
    args = (jnp.asarray(kv_start, jnp.int32), None, causal, window, D ** -0.5)
    ref = jfa._flash_fwd_hm(
        jnp.asarray(qt), jnp.asarray(kt), jnp.asarray(vt), *args, q_len=q_len, block_q=64,
    )
    out = tfa._flash_fwd_hm(
        _t(qt), _t(kt), _t(vt), torch.tensor(kv_start, dtype=torch.int32), None,
        causal, window, D ** -0.5, q_len=q_len,
    ).numpy()
    valid = _valid_rows(B, S, kv_start, q_len)  # (B, S) over query rows
    o, r = out.transpose(0, 2, 1, 3), np.asarray(ref).transpose(0, 2, 1, 3)
    np.testing.assert_allclose(o[valid], r[valid], rtol=TOL, atol=TOL)
    assert np.isfinite(out).all()


def test_head_major_key_mask_waits_for_qwen_slice():
    """The key-mask mode arrived with the Qwen2.5-VL slice: interleaved pad
    keys, non-causal, against the interpreted Pallas kernel. Every query has
    valid keys, so every row is compared."""
    rng = np.random.default_rng(5)
    B, H, S, D = 2, 2, 128, 64
    qt, kt, vt = _np(rng, B, H, S, D), _np(rng, B, H, S, D), _np(rng, B, H, S, D)
    key_mask = np.ones((B, S), np.int32)
    key_mask[1, 20:37] = 0
    key_mask[1, 90:] = 0
    kv0 = np.zeros(B, np.int32)
    ref = jfa._flash_fwd_hm(jnp.asarray(qt), jnp.asarray(kt), jnp.asarray(vt),
                            jnp.asarray(kv0), jnp.asarray(key_mask), False, None, D ** -0.5,
                            q_len=S, block_q=64)
    out = tfa._flash_fwd_hm(_t(qt), _t(kt), _t(vt), _t(kv0), _t(key_mask), False, None,
                            D ** -0.5, q_len=S).numpy()
    np.testing.assert_allclose(out, np.asarray(ref), rtol=TOL, atol=TOL)


@pytest.mark.parametrize(
    "B,H,D,route",
    [(2, 4, 96, {"prep": 3, "fa_hm": 1}), (32, 4, 32, {"fa_direct": 1})],
)
def test_fused_dispatch_routes_like_jax(B, H, D, route):
    """The dispatch of _fused_qkv_attention_fwd_impl: B1 when
    B*(H/g) >= 32, else B2 three times then B3; on CPU tensors the plain
    versions run, and agree with the split+rope+reference fallback."""
    rng = np.random.default_rng(4)
    S = 64
    qkv = _t(_np(rng, B, S, 3 * H * D))
    cos, sin = (_t(a) for a in _cos_sin(B, S, D))
    mask = torch.ones(B, S, dtype=torch.int32)
    mask[0, :9] = 0
    kw = dict(n_heads=H, n_kv_heads=H, head_dim=D, causal=True, key_padding_mask=mask)
    tfa.reset_counters()
    fused = tatt.fused_rope_attention(qkv, cos, sin, impl="pallas", **kw)
    assert {k: v for k, v in tfa.PLAIN_CALLS.items() if v} == route
    assert all(v == 0 for v in tfa.LAUNCHES.values())
    ref = tatt.fused_rope_attention(qkv, cos, sin, impl="xla", **kw)
    valid = mask.bool().numpy()
    np.testing.assert_allclose(fused.numpy()[valid], ref.numpy()[valid], rtol=TOL, atol=TOL)


def test_small_head_dims_run_the_kernels_zero_padded(monkeypatch):
    """On the card a head_dim the kernels do not take (a tiny config's 16)
    runs B3 and B8 zero-padded to 64, as the Pallas kernels pad it to a lane
    width (flash_attention.py:329-343): the output and the gradients equal
    the JAX function's at head_dim 16. The launches are stood in for here
    by the plain versions, which record the head_dim they are given."""
    assert [tfa.padded_head_dim(d) for d in (8, 16, 64, 72, 80, 96, 128, 160)] == \
        [64, 64, 64, 80, 80, 96, 128, 160]
    seen = []

    def fwd(qt, kt, vt, kv_start, causal, window, scale, q_len, key_mask=None, segments=False):
        seen.append(("fa_hm", qt.shape[-1]))
        return tfa.flash_fwd_hm_plain(qt, kt, vt, kv_start, causal=causal,
                                      sliding_window=window, scale=scale, q_len=q_len,
                                      key_mask=key_mask, segments=segments)

    def bwd(qt, kt, vt, gt, kv_start, causal, window, scale, q_len, key_mask=None,
            segments=False):
        seen.append(("fa_bwd", qt.shape[-1]))
        return tfa.flash_bwd_plain(qt, kt, vt, gt, kv_start, causal=causal,
                                   sliding_window=window, scale=scale, q_len=q_len,
                                   key_mask=key_mask, segments=segments)

    monkeypatch.setattr(tfa, "on_card", lambda t: True)
    monkeypatch.setattr(tfa, "_launch_fa_hm", fwd)
    monkeypatch.setattr(tfa, "_launch_fa_bwd", bwd)
    rng = np.random.default_rng(5)
    B, S, H, D = 2, 96, 2, 16
    q, k, v, g = (_np(rng, B, S, H, D) for _ in range(4))
    mask = np.ones((B, S), np.int32)
    mask[1, :23] = 0
    g = g * mask[:, :, None, None]  # zero on left-pad rows, as on the training path
    ts = [_t(x).requires_grad_() for x in (q, k, v)]
    out = tfa.flash_attention(*ts, causal=True, key_padding_mask=_t(mask))
    assert out.shape == (B, S, H, D)
    (out * _t(g)).sum().backward()
    assert seen == [("fa_hm", 64), ("fa_bwd", 64)]

    import jax

    def loss(q, k, v):
        o = jfa.flash_attention(q, k, v, causal=True, key_padding_mask=jnp.asarray(mask))
        return (o * g).sum(), o

    (_, ref), grads = jax.value_and_grad(loss, argnums=(0, 1, 2), has_aux=True)(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    valid = mask.astype(bool)  # left-pad query rows depend on the keys visited
    np.testing.assert_allclose(out.detach().numpy()[valid], np.asarray(ref)[valid],
                               rtol=TOL, atol=TOL)
    for t, r in zip(ts, grads):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(r), rtol=TOL, atol=TOL)
