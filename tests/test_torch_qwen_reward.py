"""The Qwen2.5-VL reward slice against the JAX package's, fp32 on the CPU:
SkipCA's qwen mode, reward_forward / paired_forward (M-RoPE positions
stacked on axis 1), and rewards through ``RewardAdaptor(model_type="qwen")
.make_score_fn`` on left-padded pairs with right-padded patch budgets, held
to PARITY.md's bar (max reward gap <= 2.03e-05 in f32, same pairwise
decisions):

- on the reference route (``attn_impl="auto"`` on CPU tensors);
- on the kernel route at a lane-aligned config (``"pallas"``): JAX runs its
  Pallas kernels interpreted, the port its plain versions;
- with the decoder W8A8 (quantized, then fused as the adaptor does), on the
  dynamic route and on the epilogue route (JAX with ``clip_vit._on_tpu``
  patched True), within 2e-3 with the same decisions (the bound of
  tests/test_torch_quant_kernels.py: XLA's rsqrt and summation order flip
  an int8 code near a rounding boundary now and then);
- u8 patches, normalised on the device by the port, against the JAX forward
  on the same image normalised on the host.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from llava_reward_tpu.core.config import RewardConfig as JRewardConfig
from llava_reward_tpu.models import clip_vit as jclip
from llava_reward_tpu.models import qwen25_vl as jq
from llava_reward_tpu.preprocess import collate as jcollate
from llava_reward_tpu.reward import skipca as jskipca
from llava_reward_tpu.reward.model import init_head_params as j_init_head
from llava_reward_tpu.reward.model import paired_forward as j_paired
from llava_reward_tpu.reward.model import reward_forward as j_reward
from llava_reward_tpu.reward.preference import preference_prob as j_pref
from llava_reward_tpu.utils import quantize as jquant
from llava_reward_torch.core import config as tconfig
from llava_reward_torch.evalx.adaptor import RewardAdaptor
from llava_reward_torch.io.convert import to_torch
from llava_reward_torch.ops import flash_attention as tfa
from llava_reward_torch.ops import int8_matmul as tim
from llava_reward_torch.ops import quant_epilogue as tqe
from llava_reward_torch.preprocess import collate as tcollate
from llava_reward_torch.reward import skipca as tskipca
from llava_reward_torch.reward.model import paired_forward as t_paired
from llava_reward_torch.reward.model import reward_forward as t_reward
from llava_reward_torch.reward.preference import preference_prob as t_pref
from test_torch_qwen_model import (image_sample, jax_tree, jit_call, jtree, lane_aligned_configs,
                                   tiny_configs)

PARITY_BAR = 2.03e-05  # PARITY.md: max |reward| gap in f32
W8A8_TOL = 2e-3
GRIDS = [(1, 8, 12), (1, 4, 6), (1, 8, 8), (1, 6, 12)]  # full and partial windows


def _rcfgs(layer_id):
    kw = dict(is_general_preference=True, value_head_dim=2, add_cross_attention=True,
              layer_id=layer_id)
    return JRewardConfig(**kw), tconfig.RewardConfig(**kw)


def _setup(aligned, fused=False, w8a8=False):
    jcfg, tcfg = lane_aligned_configs() if aligned else tiny_configs()
    jr, tr = _rcfgs(jcfg.text.num_layers)
    tree = {"backbone": jax_tree(jcfg),
            "head": jax.tree_util.tree_map(np.asarray,
                                           j_init_head(jax.random.PRNGKey(1), jcfg, jr))}
    text = tree["backbone"]["text"]
    if w8a8:  # as the adaptor loads it: quantize, then fuse
        text["layers"] = jquant.quantize_stacked_layers(text["layers"], scheme="w8a8",
                                                        min_size=0)
    if fused or w8a8:
        text["layers"] = jq.fuse_decoder_projections(text["layers"])
    return jcfg, tcfg, jr, tr, tree, to_torch(tree, device="cpu")


@pytest.fixture(scope="module")
def tiny():
    return _setup(False)


@pytest.fixture(scope="module")
def aligned():
    return _setup(True, fused=True)


def _batch(cfg, pads, seed, u8=False, seq_len=72):
    """Collated numpy fields: one image per row (grids cycle through GRIDS),
    row i left-padded by ``pads[i]`` beyond its own length."""
    rng = np.random.default_rng(seed)
    samples = [image_sample(cfg, rng, GRIDS[i % len(GRIDS)], n_before=2 + i,
                            n_after=seq_len - 60 - p, u8=u8)
               for i, p in enumerate(pads)]
    return tcollate.collate_qwen_samples(samples, seq_len, cfg.text.pad_token_id,
                                         patch_budget=128, unit_budget=24)


def _jb(fields):
    return jcollate.to_reward_batch({k: None if v is None else jnp.asarray(v)
                                     for k, v in fields.items()})


def _tb(fields):
    return tcollate.to_reward_batch(fields, device="cpu")


def _decisions(r, pairs, pref):
    kw = dict(is_general_preference=True, value_head_dim=2, tau=0.1)
    return np.asarray(pref(r[:pairs], r[pairs:], **kw)) > 0.5


def _assert_parity(j, t, pairs, tol=PARITY_BAR):
    gap = np.abs(t - j).max()
    assert gap <= tol, gap
    dj = _decisions(jnp.asarray(j), pairs, j_pref)
    dt = _decisions(torch.from_numpy(t), pairs, t_pref)
    assert (dj == dt).all()


def test_skipca_qwen_mode_matches_jax(tiny):
    *_, jt, tt = tiny
    rng = np.random.default_rng(3)
    B, S, T, H = 3, 10, 24, 64
    hidden = rng.standard_normal((B, S, H)).astype(np.float32)
    vision = rng.standard_normal((B, T, H)).astype(np.float32)
    nimg = np.array([24, 6, 13], np.int32)
    vision[np.arange(T)[None, :] >= nimg[:, None]] = 0.0
    j = jskipca.apply(jtree(jt["head"]["skipca"]), *map(jnp.asarray, (hidden, vision, nimg)),
                      rms_eps=1e-6, mode="qwen")
    t = tskipca.apply(tt["head"]["skipca"], *map(torch.from_numpy, (hidden, vision, nimg)),
                      rms_eps=1e-6, mode="qwen")
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("training", [False, True], ids=["eval", "train"])
def test_reward_forward_matches_jax(tiny, training):
    jcfg, tcfg, jr, tr, jt, tt = tiny
    fields = _batch(tcfg, [0, 9], seed=1)
    j = jit_call(lambda p, b: j_reward(p, jcfg, jr, b, training=training), jtree(jt),
                 _jb(fields))
    t = t_reward(tt, tcfg, tr, _tb(fields), training=training)
    assert tuple(t.reward.shape) == (2, 2)
    np.testing.assert_allclose(t.reward.numpy(), np.asarray(j.reward), rtol=0, atol=PARITY_BAR)
    np.testing.assert_allclose(t.last_hidden.numpy()[:, -1], np.asarray(j.last_hidden)[:, -1],
                               rtol=0, atol=1e-4)


def test_paired_forward_matches_jax(tiny):
    jcfg, tcfg, jr, tr, jt, tt = tiny
    chosen, rejected = _batch(tcfg, [0, 5], seed=2), _batch(tcfg, [7, 0], seed=3)
    jc, jrj, _, _ = jit_call(lambda p, c, r: j_paired(p, jcfg, jr, c, r, training=False),
                             jtree(jt), _jb(chosen), _jb(rejected))
    tc, trj, _, _ = t_paired(tt, tcfg, tr, _tb(chosen), _tb(rejected), training=False)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=0, atol=PARITY_BAR)
    np.testing.assert_allclose(trj.numpy(), np.asarray(jrj), rtol=0, atol=PARITY_BAR)


def _score_both(setup, fields, t_impl, j_impl, pairs):
    jcfg, tcfg, jr, tr, jt, tt = setup
    j = np.asarray(jit_call(lambda p, b: j_reward(p, jcfg, jr, b, training=False,
                                                  attn_impl=j_impl).reward,
                            jtree(jt), _jb(fields)))
    adaptor = RewardAdaptor(tcfg, tr, tt, model_type="qwen", device="cpu")
    assert adaptor.make_score_fn(attn_impl=t_impl) is adaptor.make_score_fn(attn_impl=t_impl)
    t = adaptor.make_score_fn(attn_impl=t_impl)(tt, _tb(fields)).numpy()
    assert t.shape == (2 * pairs, 2) and np.isfinite(t).all()
    return j, t


def test_score_fn_slice_matches_jax_on_the_reference_route(tiny):
    """Three pairs, chosen rows first; several rows left-padded."""
    fields = _batch(tiny[1], [0, 6, 11, 3, 0, 8], seed=4)
    j, t = _score_both(tiny, fields, "auto", "auto", 3)
    _assert_parity(j, t, 3)


def test_score_fn_slice_through_plain_kernels_matches_pallas(aligned):
    """Lane-aligned config, fused decoder: JAX runs the interpreted prep +
    _fa_kernel (decoder), _fa_kernel's segment mode (full block) and
    key-mask mode (window block); the port runs its plain B2 / B3."""
    fields = _batch(aligned[1], [0, 7, 4, 0], seed=5)
    tfa.reset_counters()
    j, t = _score_both(aligned, fields, "pallas", "pallas", 2)
    L = aligned[1].text.num_layers
    assert tfa.PLAIN_CALLS == {"fa_direct": 0, "prep": 3 * L, "fa_hm": L + 2, "fa_bwd": 0}
    assert not any(tfa.LAUNCHES.values())
    _assert_parity(j, t, 2)


@pytest.mark.parametrize("route", ["dynamic", "epilogue"])
def test_w8a8_score_fn_matches_jax(route, monkeypatch):
    setup = _setup(True, w8a8=True)
    fields = _batch(setup[1], [0, 9, 3, 0], seed=6)
    if route == "epilogue":
        monkeypatch.setattr(jclip, "_on_tpu", lambda: True)  # interpreted epilogues
    tqe.reset_counters()
    tim.reset_counters()
    j, t = _score_both(setup, fields, "pallas" if route == "epilogue" else "auto", "xla", 2)
    L = setup[1].text.num_layers
    if route == "epilogue":  # B4 x2, B5 and o_proj's dynamic form (B6 + GEMM)
        want = {"rms_quant": 2 * L, "silu_mul_quant": L, "row_quant": L, "ln_quant": 0}
    else:
        want = {"rms_quant": 0, "silu_mul_quant": 0, "row_quant": 4 * L, "ln_quant": 0}
    assert tqe.PLAIN_CALLS == want and tim.PLAIN_CALLS == {"int8_matmul": 4 * L}
    _assert_parity(j, t, 2, tol=W8A8_TOL)


def test_u8_patches_score_like_host_normalised_f32(tiny):
    """u8 patch banks (the registry's default) through the port, against the
    JAX forward on the same images normalised on the host: the JAX
    ``forward`` casts u8 patches to the compute dtype before
    ``vision_forward``, which skips its on-device normalisation, so the host
    path is the JAX package's meaning of these pixels."""
    jcfg, tcfg, jr, tr, jt, tt = tiny
    fields = _batch(tcfg, [0, 4, 2, 0], seed=7, u8=True)
    assert fields["pixel_values"].dtype == np.uint8
    host = dict(fields)
    host["pixel_values"] = np.stack([tcollate._host_norm(p, v) for p, v in
                                     zip(fields["pixel_values"], fields["patch_valid"])])
    j = np.asarray(jit_call(lambda p, b: j_reward(p, jcfg, jr, b, training=False).reward,
                            jtree(jt), _jb(host)))
    adaptor = RewardAdaptor(tcfg, tr, tt, model_type="qwen", device="cpu")
    t = adaptor.make_score_fn()(tt, _tb(fields)).numpy()
    _assert_parity(j, t, 2)


def test_adaptor_checks_the_model_type(tiny):
    _, tcfg, _, tr, _, tt = tiny
    with pytest.raises(ValueError, match="Qwen25VLConfig"):
        RewardAdaptor(tconfig.phi3v_tiny_config(), tr, tt, model_type="qwen", device="cpu")
    with pytest.raises(ValueError, match="LlavaNextConfig"):
        RewardAdaptor(tcfg, tr, tt, model_type="llava", device="cpu")
    with pytest.raises(ValueError, match="unknown model_type"):
        RewardAdaptor(tcfg, tr, tt, model_type="gpt", device="cpu")
