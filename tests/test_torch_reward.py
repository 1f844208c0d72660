"""The port's reward path against the JAX package's, fp32 on the CPU:
SkipCA, reward_forward, paired_forward, preference_prob, and the slice as a
whole through RewardAdaptor.make_score_fn on left-padded pairs, held to
PARITY.md's bar (max reward gap <= 2.03e-05 in f32, same pairwise
decisions). One param tree (JAX init, carried across) and one set of numpy
inputs feed both."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from llava_reward_tpu.core.config import RewardConfig as JRewardConfig
from llava_reward_tpu.core.config import phi3v_tiny_config, qwen_tiny_config
from llava_reward_tpu.models import phi3v as jphi3v
from llava_reward_tpu.models import qwen25_vl as jqwen
from llava_reward_tpu.preprocess.phi3v_processor import build_img_gather_idx
from llava_reward_tpu.reward import skipca as jskipca
from llava_reward_tpu.reward.model import RewardBatch as JBatch
from llava_reward_tpu.reward.model import init_head_params as j_init_head
from llava_reward_tpu.reward.model import paired_forward as j_paired
from llava_reward_tpu.reward.model import reward_forward as j_reward
from llava_reward_tpu.reward.preference import preference_prob as j_pref
from llava_reward_torch.core import config as tconfig
from llava_reward_torch.evalx.adaptor import RewardAdaptor
from llava_reward_torch.io.convert import to_torch
from llava_reward_torch.ops import flash_attention as tfa
from llava_reward_torch.reward import skipca as tskipca
from llava_reward_torch.reward.model import RewardBatch as TBatch
from llava_reward_torch.reward.model import paired_forward as t_paired
from llava_reward_torch.reward.model import reward_forward as t_reward
from llava_reward_torch.reward.preference import preference_prob as t_pref

PARITY_BAR = 2.03e-05  # PARITY.md: max |reward| gap in f32
N_IMG = 313  # 1x1 crop grid: (1+1)*144 + 1 + 2*12


def _rcfgs(layer_id):
    kw = dict(is_general_preference=True, value_head_dim=2, add_cross_attention=True,
              layer_id=layer_id)
    return JRewardConfig(**kw), tconfig.RewardConfig(**kw)


def _setup(**cfg_kw):
    jcfg = phi3v_tiny_config(**cfg_kw)
    tcfg = tconfig.phi3v_tiny_config(**cfg_kw)
    jr, tr = _rcfgs(jcfg.decoder.num_layers)
    tree = {
        "backbone": jphi3v.init_params(jax.random.PRNGKey(0), jcfg),
        "head": j_init_head(jax.random.PRNGKey(1), jcfg, jr),
    }
    tree = jax.tree_util.tree_map(np.asarray, tree)
    return jcfg, tcfg, jr, tr, tree, to_torch(tree, device="cpu")


@pytest.fixture(scope="module")
def tiny():
    return _setup()


def _batch(cfg, pads, nimgs, S=384, seed=0):
    """Numpy fields of a left-padded batch, one row per entry of ``pads``."""
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


def _jb(fields):
    return JBatch(*map(jnp.asarray, fields))


def _tb(fields):
    return TBatch(*map(torch.from_numpy, fields))


def _jp(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def test_skipca_per_half_batch_max_matches_jax(tiny):
    *_, jtree, ttree = tiny
    rng = np.random.default_rng(3)
    B, S, T, H = 4, 12, 20, 64
    hidden = rng.standard_normal((B, S, H)).astype(np.float32)
    vision = rng.standard_normal((B, T, H)).astype(np.float32)
    nimg = np.array([20, 9, 14, 5], np.int32)
    vision[np.arange(T)[None, :] >= nimg[:, None]] = 0.0
    bm = np.array([20, 20, 14, 14], np.int32)  # per-half maxima
    j = jskipca.apply(_jp(jtree["head"]["skipca"]), *map(jnp.asarray, (hidden, vision, nimg)),
                      batch_max=jnp.asarray(bm))
    t = tskipca.apply(ttree["head"]["skipca"], *map(torch.from_numpy, (hidden, vision, nimg)),
                      batch_max=torch.from_numpy(bm))
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("training", [False, True], ids=["eval", "train"])
def test_reward_forward_matches_jax(tiny, training):
    jcfg, tcfg, jr, tr, jtree, ttree = tiny
    fields = _batch(jcfg, [0, 25], [N_IMG, N_IMG - 40])
    j = j_reward(_jp(jtree), jcfg, jr, _jb(fields), training=training)
    t = t_reward(ttree, tcfg, tr, _tb(fields), training=training)
    assert tuple(t.reward.shape) == (2, 2)
    np.testing.assert_allclose(t.reward.numpy(), np.asarray(j.reward), rtol=0, atol=PARITY_BAR)


def test_paired_forward_and_preference_match_jax(tiny):
    jcfg, tcfg, jr, tr, jtree, ttree = tiny
    chosen = _batch(jcfg, [0, 17], [N_IMG, N_IMG - 60], seed=1)
    rejected = _batch(jcfg, [30, 4], [N_IMG - 10, N_IMG - 90], seed=2)
    jc, jrj, _, jlast = j_paired(_jp(jtree), jcfg, jr, _jb(chosen), _jb(rejected),
                                 training=False)
    tc, trj, _, tlast = t_paired(ttree, tcfg, tr, _tb(chosen), _tb(rejected), training=False)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=0, atol=PARITY_BAR)
    np.testing.assert_allclose(trj.numpy(), np.asarray(jrj), rtol=0, atol=PARITY_BAR)
    for gp in (True, False):
        kw = dict(is_general_preference=gp, value_head_dim=2, tau=0.1)
        np.testing.assert_allclose(t_pref(tc, trj, **kw).numpy(),
                                   np.asarray(j_pref(jc, jrj, **kw)), rtol=1e-5, atol=1e-6)


def _score_both(jcfg, jr, jtree, adaptor, fields, impl):
    j = j_reward(_jp(jtree), jcfg, jr, _jb(fields), training=False, attn_impl=impl).reward
    t = adaptor.make_score_fn(attn_impl=impl)(adaptor.params, _tb(fields))
    return np.asarray(j), t.numpy()


def _assert_slice_parity(j, t, pairs):
    gap = np.abs(t - j).max()
    assert gap <= PARITY_BAR, gap
    kw = dict(is_general_preference=True, value_head_dim=2, tau=0.1)
    pj = np.asarray(j_pref(jnp.asarray(j[:pairs]), jnp.asarray(j[pairs:]), **kw))
    pt = t_pref(torch.from_numpy(t[:pairs]), torch.from_numpy(t[pairs:]), **kw).numpy()
    assert ((pj > 0.5) == (pt > 0.5)).all()


def test_score_fn_slice_matches_jax_on_left_padded_pairs(tiny):
    """Three pairs, chosen rows first; several rows left-padded."""
    jcfg, tcfg, jr, tr, jtree, ttree = tiny
    adaptor = RewardAdaptor(tcfg, tr, ttree, device="cpu")
    assert adaptor.make_score_fn() is adaptor.make_score_fn()
    fields = _batch(jcfg, [0, 12, 40, 33, 0, 5], [N_IMG, N_IMG - 30, N_IMG, N_IMG - 70,
                                                   N_IMG - 5, N_IMG])
    j, t = _score_both(jcfg, jr, jtree, adaptor, fields, "auto")
    _assert_slice_parity(j, t, 3)


def test_lane_aligned_slice_through_plain_kernels_matches_pallas():
    """head_dim 96, g = 4: JAX runs the interpreted prep + _fa_kernel path
    (attn_impl="pallas", B < 4); the port runs its plain B2 / B3 versions."""
    jcfg, tcfg, jr, tr, jtree, ttree = _setup(hidden_size=384, num_heads=4)
    adaptor = RewardAdaptor(tcfg, tr, ttree, device="cpu")
    fields = _batch(jcfg, [0, 21], [N_IMG, N_IMG - 50], seed=4)
    tfa.reset_counters()
    j, t = _score_both(jcfg, jr, jtree, adaptor, fields, "pallas")
    n = jcfg.decoder.num_layers
    assert tfa.PLAIN_CALLS["prep"] == 3 * n and tfa.PLAIN_CALLS["fa_hm"] >= n
    assert all(v == 0 for v in tfa.LAUNCHES.values())
    _assert_slice_parity(j, t, 1)


def test_other_families_and_u8_pixels_wait_for_their_slices(tiny):
    """Qwen2.5-VL is ported (its parity tests: tests/test_torch_qwen_*.py): a
    text-only qwen batch scores like the JAX package's. LLaVA-NeXT is ported
    too (tests/test_torch_llava.py); a config of no family raises. phi3v's
    u8 device pixels are ported
    (tests/test_torch_pixels.py, test_torch_sample_e2e.py); a u8 bank
    without its crop grid is refused, as the JAX package asserts."""
    jcfg, tcfg, jr, tr, jtree, ttree = tiny
    qj = qwen_tiny_config(vision_depth=2)
    qt = tconfig.qwen_tiny_config(vision_depth=2)
    qr = _rcfgs(qj.text.num_layers)
    qtree = jax.tree_util.tree_map(np.asarray, {
        "backbone": jqwen.init_params(jax.random.PRNGKey(2), qj),
        "head": j_init_head(jax.random.PRNGKey(3), qj, qr[0]),
    })
    rng = np.random.default_rng(9)
    ids = rng.integers(2, 400, (2, 24)).astype(np.int32)
    mask = np.ones((2, 24), np.int32)
    mask[1, :5] = 0
    pos = np.where(mask == 0, 1, np.cumsum(mask, -1) - 1).astype(np.int32)
    fields = (ids, mask, None, None, np.full((2, 24), -1, np.int32), None,
              np.stack([pos] * 3))
    j = j_reward(_jp(qtree), qj, qr[0], JBatch(*[None if f is None else jnp.asarray(f)
                                                for f in fields]), training=False)
    t = t_reward(to_torch(qtree, device="cpu"), qt, qr[1],
                 TBatch(*[None if f is None else torch.from_numpy(f) for f in fields]))
    np.testing.assert_allclose(t.reward.numpy(), np.asarray(j.reward), rtol=0, atol=PARITY_BAR)
    with pytest.raises(NotImplementedError, match="families"):
        t_reward(ttree, object(), tr, _tb(_batch(jcfg, [0], [N_IMG])))
    fields = list(_batch(jcfg, [0], [N_IMG]))
    fields[2] = np.zeros(fields[2].shape, np.uint8)
    with pytest.raises(ValueError, match="crop_grid"):
        t_reward(ttree, tcfg, tr, _tb(tuple(fields)))
