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
    x = torch.zeros(1, 2, 64, 64)
    with pytest.raises(NotImplementedError, match="slice 5"):
        tfa._flash_fwd_hm(x, x, x, torch.zeros(1, dtype=torch.int32),
                          torch.ones(1, 64), False, None, 0.125, q_len=64)


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
