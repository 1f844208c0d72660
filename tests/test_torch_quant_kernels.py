"""The plain versions of the port's W8A8 kernels (B4-B7, B9) against the JAX
package's Pallas kernels run in interpret mode, and the W8A8 decoder and
reward forward against the JAX package's, on the CPU. Inputs come from a
numpy seed and include a zero row and a row count (200) that no power of
two divides.

Rules, kernel by kernel:
- B6 ``row_quant``: codes and amax equal;
- B4 ``rms_quant``: codes equal up to one code on under 0.1 % of elements
  (torch and XLA may sum x^2 in other orders, which can move a value across
  a rounding boundary), amax within rtol 1e-6 (f32 input) or one bf16 ulp
  (bf16 input, where y is rounded to bf16 before the max);
- B9 ``ln_quant``: B4's code rule (the row mean and the centred variance are
  sums too); amax within rtol 1e-6 for f32 and for bf16 input, because y is
  NOT rounded to bf16 before the max; a zero row quantizes the bias;
- B5 ``silu_mul_quant``: within one code on under 2 % of elements
  (``tests/test_quant_epilogue.py``: sigmoid rounds differently between
  backends);
- B7: within one bf16 ulp (2^-21 relative for f32 output) of
  ``int8_matmul.w8a8_matmul(interpret=True)``, which scales by
  ``amax * (1/127)`` where the port divides by 127, and
  bit-exact against ``_int8_matmul_2d`` / ``int8_linear_pre``.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from llava_reward_tpu.core.config import RewardConfig as JRewardConfig
from llava_reward_tpu.core.config import phi3v_tiny_config
from llava_reward_tpu.models import clip_vit as jclip
from llava_reward_tpu.models import phi3 as jphi3
from llava_reward_tpu.models import phi3v as jphi3v
from llava_reward_tpu.ops import int8_matmul as jim
from llava_reward_tpu.ops import quant_epilogue as jqe
from llava_reward_tpu.preprocess.phi3v_processor import build_img_gather_idx
from llava_reward_tpu.reward.model import RewardBatch as JBatch
from llava_reward_tpu.reward.model import init_head_params as j_init_head
from llava_reward_tpu.reward.model import reward_forward as j_reward
from llava_reward_tpu.reward.preference import preference_prob as j_pref
from llava_reward_tpu.utils import quantize as jq
from llava_reward_torch.core import config as tconfig
from llava_reward_torch.evalx.adaptor import RewardAdaptor
from llava_reward_torch.io.convert import to_numpy, to_torch
from llava_reward_torch.models import phi3 as tphi3
from llava_reward_torch.ops import int8_matmul as tim
from llava_reward_torch.ops import quant_epilogue as tqe
from llava_reward_torch.reward.model import RewardBatch as TBatch
from llava_reward_torch.reward.preference import preference_prob as t_pref

DTYPES = {"f32": jnp.float32, "bf16": jnp.bfloat16}
TORCH_DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}


def _inputs(seed, M, n, dtype, scale=2.0):
    """(M, n) normal values with row 5 zero, as a JAX array and a tensor
    holding the same bits."""
    x = np.random.default_rng(seed).standard_normal((M, n)).astype(np.float32) * scale
    x[5] = 0.0
    xj = jnp.asarray(x).astype(DTYPES[dtype])
    return xj, to_torch({"x": np.asarray(xj)}, device="cpu")["x"]


def _np(t):
    return to_numpy({"t": t})["t"].astype(np.float32)


def _codes_gap(t_codes, j_codes):
    d = np.abs(_np(t_codes) - np.asarray(j_codes, np.float32))
    return d.max(), (d > 0).mean()


@pytest.mark.parametrize("M", [64, 200])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_row_quant_plain_matches_pallas(dtype, M):
    xj, xt = _inputs(0, M, 256, dtype)
    jc, js = jqe.row_quant(xj, interpret=True)
    tc, ts = tqe.row_quant(xt)
    np.testing.assert_array_equal(_np(tc), np.asarray(jc, np.float32))
    np.testing.assert_array_equal(_np(ts), np.asarray(js))
    assert _np(ts)[5, 0] == 1.0 and not _np(tc)[5].any()


@pytest.mark.parametrize("M", [64, 200])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_rms_quant_plain_matches_pallas(dtype, M):
    xj, xt = _inputs(1, M, 384, dtype)
    w = np.random.default_rng(2).standard_normal(384).astype(np.float32)
    wj = jnp.asarray(w).astype(DTYPES[dtype])
    wt = to_torch({"w": np.asarray(wj)}, device="cpu")["w"]
    jc, js = jqe.rms_quant(xj, wj, 1e-5, interpret=True)
    tc, ts = tqe.rms_quant(xt, wt, 1e-5)
    dmax, share = _codes_gap(tc, jc)
    assert dmax <= 1 and share < 1e-3, (dmax, share)
    rtol = 1e-6 if dtype == "f32" else 2 ** -7
    np.testing.assert_allclose(_np(ts), np.asarray(js), rtol=rtol, atol=0)
    assert _np(ts)[5, 0] == 1.0


@pytest.mark.parametrize("M", [64, 200, 37])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_ln_quant_plain_matches_pallas(dtype, M):
    xj, xt = _inputs(8, M, 384, dtype)
    rng = np.random.default_rng(9)
    w, b = (rng.standard_normal(384).astype(np.float32) * s for s in (1.0, 0.1))
    wj, bj = (jnp.asarray(a).astype(DTYPES[dtype]) for a in (w, b))
    wt, bt = (to_torch({"a": np.asarray(a)}, device="cpu")["a"] for a in (wj, bj))
    jc, js = jqe.ln_quant(xj, wj, bj, 1e-5, interpret=True)
    tqe.reset_counters()
    tc, ts = tqe.ln_quant(xt, wt, bt, 1e-5)
    assert tqe.PLAIN_CALLS["ln_quant"] == 1 and tqe.LAUNCHES["ln_quant"] == 0
    assert tc.dtype == torch.int8 and tuple(ts.shape) == (M, 1) and ts.dtype == torch.float32
    dmax, share = _codes_gap(tc, jc)
    assert dmax <= 1 and share < 1e-3, (dmax, share)
    np.testing.assert_allclose(_np(ts), np.asarray(js), rtol=1e-6, atol=0)
    # the zero row is LayerNorm's bias, quantized
    bias = np.asarray(bj, np.float32)
    assert _np(ts)[5, 0] == np.abs(bias).max()
    np.testing.assert_array_equal(_np(tc)[5], np.round(bias * (127.0 / np.abs(bias).max())))


def test_ln_quant_plain_zero_row_zero_bias_and_leading_axes():
    """amax := 1 and zero codes for a row LayerNorm maps to zero; leading
    axes are kept, as the tower's (crops, tokens, H) input has them."""
    x = np.random.default_rng(10).standard_normal((3, 7, 256)).astype(np.float32)
    x[1, 2] = 0.0
    w, b = np.ones(256, np.float32), np.zeros(256, np.float32)
    jc, js = jqe.ln_quant(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), 1e-5, interpret=True)
    tc, ts = tqe.ln_quant(*map(torch.from_numpy, (x, w, b)), 1e-5)
    assert tuple(tc.shape) == (3, 7, 256) and tuple(ts.shape) == (3, 7, 1)
    assert float(ts[1, 2, 0]) == 1.0 and not bool(tc[1, 2].any())
    dmax, share = _codes_gap(tc, jc)
    assert dmax <= 1 and share < 1e-3, (dmax, share)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-6, atol=0)
    assert tqe.supported(torch.zeros(2, 256)) and not tqe.supported(torch.zeros(2, 200))


@pytest.mark.parametrize("M", [64, 200])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_silu_mul_quant_plain_matches_pallas(dtype, M):
    xj, xt = _inputs(3, M, 512, dtype)
    jc, js = jqe.silu_mul_quant(xj, interpret=True)
    tc, ts = tqe.silu_mul_quant(xt)
    assert tuple(tc.shape) == (M, 256)
    dmax, share = _codes_gap(tc, jc)
    assert dmax <= 1 and share < 0.02, (dmax, share)
    rtol = 1e-5 if dtype == "f32" else 2 ** -7
    np.testing.assert_allclose(_np(ts), np.asarray(js), rtol=rtol, atol=0)


def _bf16_ulp(a: np.ndarray) -> np.ndarray:
    """One unit in the last place of |a| in bf16 (8 significant bits)."""
    return 2.0 ** (np.floor(np.log2(np.maximum(np.abs(a), 1e-30))) - 7)


@pytest.mark.parametrize("M,K,N", [(64, 256, 256), (200, 128, 384), (13, 384, 128)])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_int8_matmul_plain_matches_pallas_and_xla(dtype, M, K, N):
    xj, xt = _inputs(4, M, K, dtype, scale=1.0)
    qd = jq.quantize_array_w8a8(np.random.default_rng(5).normal(size=(K, N)) * 0.05)
    wq, ws = jnp.asarray(qd["qvalues_w8a8"]), jnp.asarray(qd["scale"])
    tw = to_torch(qd, device="cpu")
    got = tim.w8a8_matmul(xt, tw["qvalues_w8a8"], tw["scale"])
    assert got.dtype == TORCH_DTYPES[dtype] and tuple(got.shape) == (M, N)
    pallas = np.asarray(jim.w8a8_matmul(xj, wq, ws, interpret=True), np.float32)
    g = _np(got)
    # bf16: one ulp. f32: the row scales differ by up to one ulp and two
    # rounded products follow, so up to 2^-21 relative (four ulps at worst)
    tol = _bf16_ulp(pallas) if dtype == "bf16" else 2.0 ** -21 * np.abs(pallas)
    assert (np.abs(g - pallas) <= tol).all(), np.abs(g - pallas).max()
    # the XLA formulation (the default on the TPU): bit for bit
    xla = np.asarray(jq._int8_matmul_2d(xj, wq, ws), np.float32)
    np.testing.assert_array_equal(g, xla)
    assert not g[5].any()
    # the pre-quantized form on B6's codes is the same function
    codes, amax = tqe.row_quant(xt)
    pre = tim.int8_matmul_pre(codes, amax, tw["qvalues_w8a8"], tw["scale"], got.dtype)
    assert torch.equal(pre, got)


# ------------------------------------------------------------ the W8A8 model

N_IMG = 313  # 1x1 crop grid: (1+1)*144 + 1 + 2*12
CFG_KW = dict(hidden_size=128, intermediate_size=256)  # 128-multiples: the epilogue gate
TOWER_KW = dict(CFG_KW, vision_hidden=128)  # the CLIP tower at a 128-multiple too


def _w8a8_tree(cfg_kw, tower: bool):
    jcfg = phi3v_tiny_config(**cfg_kw)
    tcfg = tconfig.phi3v_tiny_config(**cfg_kw)
    kw = dict(is_general_preference=True, value_head_dim=2, add_cross_attention=True,
              layer_id=jcfg.decoder.num_layers)
    jr, tr = JRewardConfig(**kw), tconfig.RewardConfig(**kw)
    tree = {
        "backbone": jphi3v.init_params(jax.random.PRNGKey(0), jcfg),
        "head": j_init_head(jax.random.PRNGKey(1), jcfg, jr),
    }
    tree = jax.tree_util.tree_map(np.asarray, tree)
    dec = tree["backbone"]["decoder"]
    dec["layers"] = jq.quantize_stacked_layers(dec["layers"], scheme="w8a8", min_size=0)
    if tower:
        clip = tree["backbone"]["vision"]["clip"]
        clip["layers"] = jq.quantize_stacked_layers(clip["layers"], scheme="w8a8", min_size=0)
    return jcfg, tcfg, jr, tr, tree, to_torch(tree, device="cpu")


@pytest.fixture(scope="module")
def w8a8():
    """The tiny reward tree with its decoder quantized W8A8 by the JAX
    package, as numpy; the port gets the same tree through io.convert."""
    return _w8a8_tree(CFG_KW, tower=False)


@pytest.fixture(scope="module")
def w8a8_tower():
    """The same with the CLIP tower (hidden 128) quantized W8A8 as well, as
    the JAX package's tests build that configuration."""
    return _w8a8_tree(TOWER_KW, tower=True)


def _jtree(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


# Neither route is exact. XLA computes RMSNorm's 1/sqrt as rsqrt and sums
# x^2 in its own order, so about a fifth of the normalised values differ by
# one f32 ulp from the port's, and a value next to a rounding boundary takes
# the neighbouring code. One flipped code moves a projection's output row by
# amax/127 * |w| per column, ~ 4/127 * 0.05 ~ 1.6e-3 at this size (|h| ~ 4,
# std-0.02 weights), and attention and the next layer spread it: the tiny
# reward forward's decoder states differ by up to 3.2e-2, its rewards
# (|reward| ~ 0.1) by 6.0e-4 to 6.9e-4 over three seeds. The bounds leave a
# factor of about 1.5 and 3 above that.
HIDDEN_TOL = 5e-2
REWARD_TOL = 2e-3

ROUTES = {
    # port attn_impl, whether JAX runs with _on_tpu() patched True
    "dynamic": ("auto", False),
    "epilogue": ("pallas", True),
}


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_w8a8_decoder_matches_jax(w8a8, route, monkeypatch):
    jcfg, tcfg, _, _, tree, ttree = w8a8
    impl, patch = ROUTES[route]
    B, S, H = 2, 40, jcfg.decoder.hidden_size
    rng = np.random.default_rng(6)
    emb = rng.standard_normal((B, S, H)).astype(np.float32)
    mask = np.ones((B, S), np.int32)
    mask[1, :9] = 0
    pos = np.where(mask == 0, 1, np.cumsum(mask, -1) - 1).astype(np.int32)
    if patch:
        monkeypatch.setattr(jclip, "_on_tpu", lambda: True)  # interpreted epilogues
    j = jphi3.forward(_jtree(tree["backbone"]["decoder"]), jcfg.decoder, jnp.asarray(emb),
                      jnp.asarray(mask), jnp.asarray(pos), attn_impl="xla")
    tqe.reset_counters()
    tim.reset_counters()
    t = tphi3.forward(ttree["backbone"]["decoder"], tcfg.decoder, torch.from_numpy(emb),
                      torch.from_numpy(mask), torch.from_numpy(pos), attn_impl=impl)
    L = jcfg.decoder.num_layers
    if route == "epilogue":
        want = {"rms_quant": 2 * L, "silu_mul_quant": L, "row_quant": L, "ln_quant": 0}
    else:  # the dynamic form quantizes each projection's input by rows
        want = {"rms_quant": 0, "silu_mul_quant": 0, "row_quant": 4 * L, "ln_quant": 0}
    assert tqe.PLAIN_CALLS == want and tim.PLAIN_CALLS == {"int8_matmul": 4 * L}
    assert not any(tqe.LAUNCHES.values()) and not any(tim.LAUNCHES.values())
    valid = mask.astype(bool)
    np.testing.assert_allclose(t.last_hidden_state.numpy()[valid],
                               np.asarray(j.last_hidden_state)[valid], rtol=0, atol=HIDDEN_TOL)


def _batch(cfg, pads, nimgs, S=384, seed=0):
    B = len(pads)
    rng = np.random.default_rng(seed)
    gidx = np.tile(build_img_gather_idx(1, 1, cfg.num_crops, budget=N_IMG)[None], (B, 1))
    mask = np.ones((B, S), np.int32)
    splice = np.full((B, S), -1, np.int32)
    for i, pad in enumerate(pads):
        mask[i, :pad] = 0
        splice[i, pad + 1 : pad + 1 + N_IMG] = np.arange(N_IMG)
    ids = rng.integers(2, cfg.decoder.vocab_size - 2, (B, S)).astype(np.int32)
    ids[mask == 0] = cfg.decoder.pad_token_id
    pix = rng.uniform(-1, 1, (B, cfg.num_crops + 1, 336, 336, 3)).astype(np.float32)
    return (ids, mask, pix, gidx, splice, np.asarray(nimgs, np.int32))


def _reward_slice(fixture, route, monkeypatch):
    jcfg, tcfg, jr, tr, tree, ttree = fixture
    impl, patch = ROUTES[route]
    fields = _batch(jcfg, [0, 30, 12, 0], [N_IMG, N_IMG - 40, N_IMG - 7, N_IMG], seed=7)
    if patch:
        monkeypatch.setattr(jclip, "_on_tpu", lambda: True)
    j = np.asarray(j_reward(_jtree(tree), jcfg, jr, JBatch(*map(jnp.asarray, fields)),
                            training=False, attn_impl="xla").reward)
    adaptor = RewardAdaptor(tcfg, tr, ttree, device="cpu")
    t = adaptor.make_score_fn(attn_impl=impl)(ttree, TBatch(*map(torch.from_numpy, fields)))
    t = t.numpy()
    assert t.shape == (4, 2) and np.isfinite(t).all()
    gap = np.abs(t - j).max()
    assert gap <= REWARD_TOL, gap
    kw = dict(is_general_preference=True, value_head_dim=2, tau=0.1)
    pj = np.asarray(j_pref(jnp.asarray(j[:2]), jnp.asarray(j[2:]), **kw))
    pt = t_pref(torch.from_numpy(t[:2]), torch.from_numpy(t[2:]), **kw).numpy()
    assert ((pj > 0.5) == (pt > 0.5)).all()


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_w8a8_reward_slice_matches_jax(w8a8, route, monkeypatch):
    """Two pairs, chosen rows first, through RewardAdaptor.make_score_fn."""
    _reward_slice(w8a8, route, monkeypatch)


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_w8a8_tower_and_decoder_reward_slice_matches_jax(w8a8_tower, route, monkeypatch):
    """The same request with the CLIP tower W8A8 too: on the epilogue route
    ln2 -> fc1 goes through ``ln_quant`` in both packages (JAX's runs
    interpreted). The tower's flipped codes (see HIDDEN_TOL above) add to the
    decoder's: the rewards differed by up to 7.6e-4 over both routes, within the
    same REWARD_TOL, and the decisions agree."""
    tqe.reset_counters()
    _reward_slice(w8a8_tower, route, monkeypatch)
    L = w8a8_tower[0].vision.num_active_layers
    assert tqe.PLAIN_CALLS["ln_quant"] == (L if route == "epilogue" else 0)
