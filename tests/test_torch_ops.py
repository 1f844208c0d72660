"""The port's norms, activations, RoPE and attention reference against the
JAX package's, fp32 on the CPU, inputs from a numpy seed. Tolerance 1e-5
(fp32 elementwise; 2e-5 where a reduction over the sequence is summed in
another order)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from llava_reward_tpu.core.config import phi35_vision_config
from llava_reward_tpu.ops import activations as jact
from llava_reward_tpu.ops import attention as jatt
from llava_reward_tpu.ops import norms as jnorms
from llava_reward_tpu.ops import rope as jrope
from llava_reward_torch.core import config as tconfig
from llava_reward_torch.ops import activations as tact
from llava_reward_torch.ops import attention as tatt
from llava_reward_torch.ops import norms as tnorms
from llava_reward_torch.ops import rope as trope

TOL = 1e-5


def _x(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32) * 2


def _close(t, j, tol=TOL):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=tol, atol=tol)


def test_rms_norm_matches_jax():
    x, w = _x(0, 3, 7, 64), _x(1, 64)
    _close(tnorms.rms_norm(torch.from_numpy(x), torch.from_numpy(w), 1e-5),
           jnorms.rms_norm(jnp.asarray(x), jnp.asarray(w), 1e-5))


def test_layer_norm_matches_jax():
    x, w, b = _x(2, 3, 7, 32), _x(3, 32), _x(4, 32)
    _close(tnorms.layer_norm(*map(torch.from_numpy, (x, w, b)), 1e-5),
           jnorms.layer_norm(*map(jnp.asarray, (x, w, b)), 1e-5))


@pytest.mark.parametrize("name", sorted(jact.ACT2FN))
def test_activations_match_jax(name):
    x = _x(5, 4, 33)
    _close(tact.ACT2FN[name](torch.from_numpy(x)), jact.ACT2FN[name](jnp.asarray(x)))


@pytest.mark.parametrize("max_pos", [300, 5000], ids=["short_factor", "long_factor"])
def test_su_rope_cos_sin_match_jax(max_pos):
    """Both su factor branches: long iff max(position_ids)+1 > 4096."""
    dcfg = phi35_vision_config().decoder
    tcfg = tconfig.phi35_vision_config().decoder
    pos = np.stack([np.arange(max_pos - 64, max_pos), np.arange(64)]).astype(np.int32)
    tc, ts = trope.rope_cos_sin_for_config(torch.from_numpy(pos), tcfg, dtype=torch.float32)
    jc, js = jrope.rope_cos_sin_for_config(jnp.asarray(pos), dcfg, dtype=jnp.float32)
    _close(tc, jc, 2e-5)
    _close(ts, js, 2e-5)


def test_base_rope_and_apply_rotary_match_jax():
    pos = np.broadcast_to(np.arange(40), (2, 40)).astype(np.int32)
    tc, ts = trope.compute_rope_cos_sin(torch.from_numpy(pos), 16, dtype=torch.float32)
    jc, js = jrope.compute_rope_cos_sin(jnp.asarray(pos), 16, dtype=jnp.float32)
    _close(tc, jc)
    q, k = _x(6, 2, 40, 4, 16), _x(7, 2, 40, 2, 16)
    tq, tk = trope.apply_rotary(torch.from_numpy(q), torch.from_numpy(k), tc, ts)
    jq, jk = jrope.apply_rotary(jnp.asarray(q), jnp.asarray(k), jc, js)
    _close(tq, jq)
    _close(tk, jk)


ATTN_CASES = {
    "causal_leftpad": dict(causal=True, pad=5, window=None, seg=False, hk=4),
    "full_keypad_gqa": dict(causal=False, pad=9, window=None, seg=False, hk=2),
    "causal_window": dict(causal=True, pad=0, window=7, seg=False, hk=4),
    "segments": dict(causal=False, pad=0, window=None, seg=True, hk=4),
}


@pytest.mark.parametrize("case", sorted(ATTN_CASES))
def test_attention_reference_matches_jax(case):
    c = ATTN_CASES[case]
    B, S, H, D = 2, 24, 4, 16
    q, k, v = _x(8, B, S, H, D), _x(9, B, S, c["hk"], D), _x(10, B, S, c["hk"], D)
    mask = np.ones((B, S), np.int32)
    mask[1, : c["pad"]] = 0
    seg = np.repeat(np.array([[1, 2, 2, 0]]), S // 4, axis=1).repeat(B, 0).astype(np.int32)
    kw = dict(causal=c["causal"], sliding_window=c["window"])
    if c["seg"]:
        tkw = dict(kw, segment_ids=torch.from_numpy(seg))
        jkw = dict(kw, segment_ids=jnp.asarray(seg))
    else:
        tkw = dict(kw, key_padding_mask=torch.from_numpy(mask))
        jkw = dict(kw, key_padding_mask=jnp.asarray(mask))
    t = tatt.attention_reference(*map(torch.from_numpy, (q, k, v)), **tkw)
    j = jatt.attention_reference(*map(jnp.asarray, (q, k, v)), **jkw)
    valid = (seg != 0) if c["seg"] else mask.astype(bool)
    np.testing.assert_allclose(t.numpy()[valid], np.asarray(j)[valid], rtol=2e-5, atol=2e-5)


def test_fused_rope_attention_fallback_matches_jax():
    """The split + rope + mha fallback (tiny head_dim never takes the
    fused path on either side)."""
    B, S, H, D = 2, 32, 4, 16
    qkv = _x(11, B, S, 3 * H * D)
    pos = np.broadcast_to(np.arange(S), (B, S)).astype(np.int32)
    jc, js = jrope.compute_rope_cos_sin(jnp.asarray(pos), D, dtype=jnp.float32)
    mask = np.ones((B, S), np.int32)
    mask[0, :6] = 0
    kw = dict(n_heads=H, n_kv_heads=H, head_dim=D, causal=True)
    j = jatt.fused_rope_attention(jnp.asarray(qkv), jc, js, key_padding_mask=jnp.asarray(mask),
                                  impl="auto", **kw)
    t = tatt.fused_rope_attention(torch.from_numpy(qkv), torch.from_numpy(np.array(jc)),
                                  torch.from_numpy(np.array(js)),
                                  key_padding_mask=torch.from_numpy(mask), impl="auto", **kw)
    valid = mask.astype(bool)
    np.testing.assert_allclose(t.numpy()[valid], np.asarray(j)[valid], rtol=2e-5, atol=2e-5)
