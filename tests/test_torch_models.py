"""The port's CLIP tower, Phi-3 decoder and Phi-3-V backbone against the
JAX package's at ``phi3v_tiny_config``, fp32 on the CPU: one param tree
(made by the JAX ``init_params``, carried across by ``io.convert``) and
one set of numpy inputs feed both. Tolerance 1e-4 on hidden states of
magnitude ~1 after 2-layer stacks (fp32, different matmul summation
orders); left-pad rows are not compared."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from llava_reward_tpu.core.config import phi3v_tiny_config
from llava_reward_tpu.models import clip_vit as jclip
from llava_reward_tpu.models import phi3 as jphi3
from llava_reward_tpu.models import phi3v as jphi3v
from llava_reward_tpu.preprocess.phi3v_processor import build_img_gather_idx
from llava_reward_torch.core import config as tconfig
from llava_reward_torch.io.convert import to_torch
from llava_reward_torch.models import clip_vit as tclip
from llava_reward_torch.models import phi3 as tphi3
from llava_reward_torch.models import phi3v as tphi3v

TOL = 1e-4


@pytest.fixture(scope="module")
def tiny():
    jcfg = phi3v_tiny_config()
    tcfg = tconfig.phi3v_tiny_config()
    params = jax.tree_util.tree_map(np.asarray, jphi3v.init_params(jax.random.PRNGKey(0), jcfg))
    return jcfg, tcfg, params, to_torch(params, device="cpu")


def _close(t, j, mask=None):
    t, j = t.numpy(), np.asarray(j)
    if mask is not None:
        t, j = t[mask], j[mask]
    np.testing.assert_allclose(t, j, rtol=TOL, atol=TOL)


def test_clip_patch_features_match_jax(tiny):
    jcfg, tcfg, jp, tp = tiny
    pix = np.random.default_rng(0).uniform(-1, 1, (2, 336, 336, 3)).astype(np.float32)
    j = jclip.extract_patch_features(
        jax.tree_util.tree_map(jnp.asarray, jp["vision"]["clip"]), jcfg.vision, jnp.asarray(pix)
    )
    t = tclip.extract_patch_features(tp["vision"]["clip"], tcfg.vision, torch.from_numpy(pix))
    assert tuple(t.shape) == (2, jcfg.vision.num_patches, jcfg.vision.hidden_size)
    _close(t, j)


@pytest.mark.parametrize("collect", [None, 1], ids=["last", "collect_layer1"])
def test_phi3_decoder_matches_jax(tiny, collect):
    jcfg, tcfg, jp, tp = tiny
    B, S, H = 2, 40, jcfg.decoder.hidden_size
    rng = np.random.default_rng(1)
    emb = rng.standard_normal((B, S, H)).astype(np.float32)
    mask = np.ones((B, S), np.int32)
    mask[1, :11] = 0
    pos = np.where(mask == 0, 1, np.cumsum(mask, -1) - 1).astype(np.int32)
    j = jphi3.forward(jax.tree_util.tree_map(jnp.asarray, jp["decoder"]), jcfg.decoder,
                      jnp.asarray(emb), jnp.asarray(mask), jnp.asarray(pos),
                      collect_layer_id=collect)
    t = tphi3.forward(tp["decoder"], tcfg.decoder, torch.from_numpy(emb),
                      torch.from_numpy(mask), torch.from_numpy(pos), collect_layer_id=collect)
    valid = mask.astype(bool)
    _close(t.last_hidden_state, j.last_hidden_state, valid)
    if collect is None:
        assert t.collected_hidden_state is None and j.collected_hidden_state is None
    else:
        _close(t.collected_hidden_state, j.collected_hidden_state, valid)


def test_phi3v_forward_matches_jax(tiny):
    jcfg, tcfg, jp, tp = tiny
    B, S = 2, 352
    n_img = 313  # 1x1 crop grid
    rng = np.random.default_rng(2)
    gidx = np.tile(build_img_gather_idx(1, 1, jcfg.num_crops, budget=n_img)[None], (B, 1))
    mask = np.ones((B, S), np.int32)
    splice = np.full((B, S), -1, np.int32)
    for i, pad in enumerate((0, 20)):
        mask[i, :pad] = 0
        splice[i, pad + 1 : pad + 1 + n_img] = np.arange(n_img)
    ids = rng.integers(2, jcfg.decoder.vocab_size - 2, (B, S)).astype(np.int32)
    pos = np.where(mask == 0, 1, np.cumsum(mask, -1) - 1).astype(np.int32)
    pix = rng.uniform(-1, 1, (B, jcfg.num_crops + 1, 336, 336, 3)).astype(np.float32)
    nimg = np.array([n_img, n_img - 100], np.int32)
    args = (ids, mask, pos, pix, gidx, splice, nimg)
    j = jphi3v.forward(jax.tree_util.tree_map(jnp.asarray, jp), jcfg,
                       *map(jnp.asarray, args), collect_layer_id=1)
    t = tphi3v.forward(tp, tcfg, *map(torch.from_numpy, args), collect_layer_id=1)
    valid = mask.astype(bool)
    _close(t.last_hidden_state, j.last_hidden_state, valid)
    _close(t.collected_hidden_state, j.collected_hidden_state, valid)
    _close(t.vision_embedding, j.vision_embedding)
