"""The sample pairs of this repository (``data/sample_test/pairwise_sample.json``
and its eight PNGs) scored end to end by both packages on the same tiny
random weights: processor -> collate -> ``to_reward_batch(device="cpu")`` ->
``RewardAdaptor.make_score_fn``, for a tiny Phi-3.5-V in its f32, u8-crop and
u8-source pixel modes and a tiny Qwen2.5-VL with f32 and u8 patches.

Bar: the same pairwise decisions and rewards within 2.03e-05 (PARITY.md).
Qwen's u8 patches are held to the JAX package's host-normalised f32 ones:
the JAX forward does not normalise u8 patches (ROADMAP §C, "found in the
reference and not copied"). Within one package the pixel modes agree: u8
crops and u8 sources give the same bank bit for bit, hence the same rewards,
and the u8 modes stand within U8_VS_F32 of the host f32 bank's rewards (the
device and host banks differ by float rounding, 1e-5 at most).
JAX twin: tests/test_e2e_sample_data.py (it reads a reference checkout).
"""

import json
import os

import numpy as np
import pytest
import torch
from PIL import Image

import jax
import jax.numpy as jnp

from llava_reward_tpu.core.config import RewardConfig as JRewardConfig
from llava_reward_tpu.core.config import phi3v_tiny_config, qwen_tiny_config
from llava_reward_tpu.evalx.adaptor import RewardAdaptor as JAdaptor
from llava_reward_tpu.models import phi3v as jphi3v
from llava_reward_tpu.models import qwen25_vl as jqwen
from llava_reward_tpu.preprocess import collate as jcollate
from llava_reward_tpu.preprocess import phi3v_processor as jpp
from llava_reward_tpu.preprocess import qwen_vision as jqv
from llava_reward_tpu.reward.model import init_head_params as j_init_head
from llava_reward_torch.core import config as tconfig
from llava_reward_torch.evalx.adaptor import RewardAdaptor as TAdaptor
from llava_reward_torch.io.convert import to_torch
from llava_reward_torch.preprocess import collate as tcollate
from llava_reward_torch.preprocess import phi3v_processor as tpp
from llava_reward_torch.preprocess import qwen_vision as tqv

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PARITY_BAR = 2.03e-05
U8_VS_F32 = 1e-4  # rewards ~1e-2; the banks differ by at most 1e-5
SEQ = 800
RCFG = dict(is_general_preference=True, value_head_dim=2, add_cross_attention=True)


class Tok:
    eos_token = "</s>"

    def __call__(self, text):
        return {"input_ids": [sum(map(ord, w)) % 400 + 3 for w in text.split()]}

    def apply_chat_template(self, msgs, tokenize=False, add_generation_prompt=True):
        content = msgs[0]["content"]
        if isinstance(content, list):  # qwen: the vision span, then the text
            return "x" * 58 + "<|image_pad|> " + content[1]["text"] + " " + "y" * 23
        return content + " " + "x" * 22


def _rows():
    with open(os.path.join(ROOT, "data/sample_test/pairwise_sample.json")) as f:
        return json.load(f)


def _open(path):
    return Image.open(os.path.join(ROOT, path)).convert("RGB")


def _sides(rows, process):
    """(chosen samples, rejected samples) in row order."""
    return ([process(r["prompt"], _open(r["chosen_path"])) for r in rows],
            [process(r["prompt"], _open(r["reject_path"])) for r in rows])


@pytest.fixture(scope="module")
def phi3v_models():
    jcfg = phi3v_tiny_config(num_layers=2, vision_layers=2, num_crops=4)
    tcfg = tconfig.phi3v_tiny_config(num_layers=2, vision_layers=2, num_crops=4)
    kw = dict(RCFG, layer_id=jcfg.decoder.num_layers)
    jr, tr = JRewardConfig(**kw), tconfig.RewardConfig(**kw)
    tree = jax.tree_util.tree_map(np.asarray, {
        "backbone": jphi3v.init_params(jax.random.PRNGKey(0), jcfg),
        "head": j_init_head(jax.random.PRNGKey(1), jcfg, jr)})
    ja = JAdaptor(cfg=jcfg, rcfg=jr, params=jax.tree_util.tree_map(jnp.asarray, tree))
    ta = TAdaptor(tcfg, tr, to_torch(tree, device="cpu"), device="cpu")
    return ja, ta


def _phi3v_rewards(ja, ta, mode):
    out = {}
    for name, pp, collate in (("jax", jpp, jcollate), ("torch", tpp, tcollate)):
        proc = pp.Phi3VProcessor(Tok(), num_crops=4, device_preproc=mode != "f32")
        proc.device_resize = mode == "u8src"
        process = lambda prompt, img: proc(pp.apply_phi3v_chat_template(  # noqa: E731
            Tok(), prompt), [img])
        chosen, rejected = _sides(_rows(), process)
        batch = collate.collate_samples(chosen + rejected, SEQ, 0)
        if name == "jax":
            rb = jcollate.to_reward_batch(batch)
            out[name] = np.asarray(ja.make_score_fn()(ja.params, jax.tree_util.tree_map(
                jnp.asarray, rb)))
        else:
            rb = tcollate.to_reward_batch(batch, device="cpu")
            assert (rb.pixel_values.dtype == torch.uint8) == (mode != "f32")
            assert (rb.resize_tabs is not None) == (mode == "u8src")
            out[name] = ta.make_score_fn()(ta.params, rb).numpy()
    return out


def _decisions(r):
    n = r.shape[0] // 2
    return np.sign(r[:n, 0] - r[n:, 0])


@pytest.fixture(scope="module")
def phi3v_rewards(phi3v_models):
    return {mode: _phi3v_rewards(*phi3v_models, mode) for mode in ("f32", "u8", "u8src")}


@pytest.mark.parametrize("mode", ["f32", "u8", "u8src"])
def test_phi3v_sample_pairs_score_alike(phi3v_rewards, mode):
    r = phi3v_rewards[mode]
    assert r["torch"].shape == (8, 2) and np.isfinite(r["torch"]).all()
    np.testing.assert_allclose(r["torch"], r["jax"], rtol=0, atol=PARITY_BAR)
    np.testing.assert_array_equal(_decisions(r["torch"]), _decisions(r["jax"]))


def test_phi3v_pixel_modes_agree(phi3v_rewards):
    t = {m: phi3v_rewards[m]["torch"] for m in phi3v_rewards}
    np.testing.assert_array_equal(t["u8src"], t["u8"])
    np.testing.assert_allclose(t["u8"], t["f32"], rtol=0, atol=U8_VS_F32)
    np.testing.assert_array_equal(_decisions(t["u8"]), _decisions(t["f32"]))


class QTok(Tok):
    def __init__(self, image_token_id):
        self.image_token_id = image_token_id

    def __call__(self, text):
        return {"input_ids": [self.image_token_id if w == "<|image_pad|>" else
                              sum(map(ord, w)) % 300 + 10 for w in text.split()]}


def test_qwen_sample_pairs_score_alike():
    jcfg, tcfg = qwen_tiny_config(vision_depth=2), tconfig.qwen_tiny_config(vision_depth=2)
    kw = dict(RCFG, layer_id=jcfg.text.num_layers)
    jr, tr = JRewardConfig(**kw), tconfig.RewardConfig(**kw)
    tree = jax.tree_util.tree_map(np.asarray, {
        "backbone": jqwen.init_params(jax.random.PRNGKey(0), jcfg),
        "head": j_init_head(jax.random.PRNGKey(1), jcfg, jr)})
    ja = JAdaptor(cfg=jcfg, rcfg=jr, params=jax.tree_util.tree_map(jnp.asarray, tree),
                  model_type="qwen")
    ta = TAdaptor(tcfg, tr, to_torch(tree, device="cpu"), model_type="qwen", device="cpu")
    tok = QTok(jcfg.text.image_token_id)
    kw = dict(min_pixels=jcfg.min_pixels, max_pixels=jcfg.max_pixels,
              image_token_id=jcfg.text.image_token_id)
    rewards = {}
    for name, qv, collate, layout in (("jax", jqv, jcollate, "f32"),
                                      ("torch", tqv, tcollate, "f32"),
                                      ("torch-u8", tqv, tcollate, "u8")):
        proc = qv.Qwen25VLProcessor(tok, device_preproc=layout == "u8", **kw)
        process = lambda prompt, img: proc(qv.apply_qwen_chat_template(  # noqa: E731
            tok, prompt), [img])
        chosen, rejected = _sides(_rows(), process)
        batch = collate.collate_qwen_samples(chosen + rejected, 40, jcfg.text.pad_token_id,
                                             128, 16)
        if name == "jax":
            rb = jax.tree_util.tree_map(jnp.asarray, jcollate.to_reward_batch(batch))
            rewards[name] = np.asarray(ja.make_score_fn()(ja.params, rb))
        else:
            rb = tcollate.to_reward_batch(batch, device="cpu")
            assert (rb.pixel_values.dtype == torch.uint8) == (layout == "u8")
            rewards[name] = ta.make_score_fn()(ta.params, rb).numpy()
    for name in ("torch", "torch-u8"):
        assert rewards[name].shape == (8, 2)
        np.testing.assert_allclose(rewards[name], rewards["jax"], rtol=0, atol=PARITY_BAR,
                                   err_msg=name)
        np.testing.assert_array_equal(_decisions(rewards[name]), _decisions(rewards["jax"]))
