"""LLaVA-NeXT in the port against the JAX package, fp32 on the CPU.

- the anyres geometry (``select_best_resolution``, the unpadded feature
  grid, token counts, gather indices) bit-equal to JAX at seeded sizes;
- ``LlavaNextProcessor``: ids, gather and splice indices equal, the f32
  tile banks within 1e-6; the collated batches equal;
- the tiny forward and rewards of left-padded pairs (one param tree from the
  JAX init, carried across): rewards within 2.03e-05 (PARITY.md), the same
  decisions; SkipCA is not wired for LLaVA in either package;
- ``load_reward_adaptor(model_type="llava")`` on a synthetic base checkpoint
  and artifact (LoRA on QWEN_TARGETS, heads, projector) written to
  ``tmp_path`` in bf16: trees and rewards as the JAX loader's, W8A8 within
  2e-3;
- the LoRA objective: loss and every trainable leaf's gradient against
  ``jax.value_and_grad`` (the bounds of tests/test_torch_qwen_train.py), and
  an fp32 projector and heads over a bf16 backbone train;
- ``io/hf_llava.py`` reads exactly the published key list
  (``tools/manifests/llava_v16_vicuna_13b/keys.txt``) at its depths, to the
  JAX loader's tree.

JAX twins: tests/test_llava_parity.py, tests/test_llava_adaptor.py.
"""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch
from PIL import Image

import jax
import jax.numpy as jnp

from llava_reward_tpu.core.config import RewardConfig as JRewardConfig
from llava_reward_tpu.core.config import llava_tiny_config
from llava_reward_tpu.evalx import adaptor as jad
from llava_reward_tpu.io import artifact as jart
from llava_reward_tpu.io.hf_llava import params_from_hf_state_dict as j_llava_params
from llava_reward_tpu.io.torch_io import save_torch_state_dict as j_save_sd
from llava_reward_tpu.lora import lora as jlora
from llava_reward_tpu.models import llava_next as jllava
from llava_reward_tpu.preprocess import collate as jcollate
from llava_reward_tpu.preprocess import llava_processor as jlp
from llava_reward_tpu.reward.model import init_head_params as j_init_head
from llava_reward_tpu.reward.model import reward_forward as j_reward
from llava_reward_tpu.train import train_step as jts
from llava_reward_torch.core import config as tconfig
from llava_reward_torch.core.registry import get_family
from llava_reward_torch.evalx import adaptor as tad
from llava_reward_torch.io import hf_llava as thl
from llava_reward_torch.io.convert import to_numpy, to_torch
from llava_reward_torch.lora.lora import QWEN_TARGETS
from llava_reward_torch.models import llava_next as tllava
from llava_reward_torch.preprocess import collate as tcollate
from llava_reward_torch.preprocess import llava_processor as tlp
from llava_reward_torch.reward.model import reward_forward as t_reward
from llava_reward_torch.train import optim as toptim
from llava_reward_torch.train import train_step as tts
from llava_reward_torch.utils.quantize import is_w8a8
from test_llava_adaptor import _llava_hf_sd

PARITY_BAR = 2.03e-05  # PARITY.md: max |reward| gap in f32
W8A8_TOL = 2e-3  # tests/test_torch_loading.py's bound for a W8A8 load
BANK_TOL = 1e-6
TREE_TOL = 1e-6  # the LoRA merge sums in another order
LOSS_TOL, GRAD_RTOL = 2e-5, 1e-4  # tests/test_torch_qwen_train.py's bounds
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MANIFEST = os.path.join(ROOT, "tools", "manifests", "llava_v16_vicuna_13b")
LLAVA_PATH = tts.PROJECTOR_PATHS["llava"]
GPM = dict(is_general_preference=True, value_head_dim=2)
# (h, w): every pinpoint's best fit, both unpad directions, and extremes
SIZES = [(200, 300), (350, 120), (672, 672), (336, 1008), (1008, 336), (50, 900),
         (1000, 1000), (17, 23), (480, 640), (700, 90)]


class Tok:
    eos_token = "</s>"

    def __init__(self, image_token_id):
        self.image_token_id = image_token_id

    def __call__(self, text):
        return {"input_ids": [self.image_token_id if w == "<image>" else sum(map(ord, w)) % 300 + 3
                              for w in text.split()]}

    def apply_chat_template(self, msgs, tokenize=False, add_generation_prompt=True):
        return "USER: " + msgs[0]["content"] + " ASSISTANT: " + "x" * 11


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, jax.device_get(tree))


def _image(h, w, seed):
    rng = np.random.default_rng(seed)
    return Image.fromarray(rng.integers(0, 256, (h, w, 3), dtype=np.uint8))


def _configs(**kw):
    return llava_tiny_config(**kw), tconfig.llava_tiny_config(**kw)


# ------------------------------------------------------------ geometry


@pytest.mark.parametrize("hw", SIZES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_anyres_geometry_and_indices_are_the_jax_ones(hw):
    h, w = hw
    assert tlp.select_best_resolution((h, w), tlp.DEFAULT_GRID_PINPOINTS) == \
        jlp.select_best_resolution((h, w), jlp.DEFAULT_GRID_PINPOINTS)
    assert tlp.anyres_feature_geometry(h, w) == jlp.anyres_feature_geometry(h, w)
    assert tlp.num_image_tokens(h, w) == jlp.num_image_tokens(h, w)
    for off in (0, 5):
        assert tlp.anyres_token_indices(h, w, tile_offset=off) == \
            jlp.anyres_token_indices(h, w, tile_offset=off)
    budget = tlp.max_image_tokens()
    t_idx, t_n = tlp.build_anyres_gather_idx(h, w, budget)
    j_idx, j_n = jlp.build_anyres_gather_idx(h, w, budget)
    assert t_n == j_n and t_idx.dtype == j_idx.dtype
    np.testing.assert_array_equal(t_idx, j_idx)


def test_llava_13b_token_budgets():
    assert tlp.num_image_tokens(672, 672) == jlp.num_image_tokens(672, 672) == 2928
    assert tlp.max_tiles() == jlp.max_tiles() == 4
    assert tlp.max_image_tokens() == jlp.max_image_tokens()
    assert tlp.NEWLINE_IDX == jlp.NEWLINE_IDX == 0


# ------------------------------------------------------------ processor


def _samples(proc_mod, cfg, prompts_images):
    tok = Tok(cfg.text.image_token_id)
    proc = proc_mod.LlavaNextProcessor(tok, image_token_id=cfg.text.image_token_id,
                                       grid_pinpoints=cfg.grid_pinpoints)
    return [proc(p, ims) for p, ims in prompts_images]


def _prompts_images():
    return [("<image> a scene", [_image(200, 300, 0)]),
            ("<image> tall", [_image(350, 120, 1)]),
            ("first <image> then <image> which?", [_image(90, 700, 2), _image(336, 336, 3)])]


def test_processor_outputs_are_the_jax_ones():
    jcfg, tcfg = _configs()
    pi = _prompts_images()
    for js, ts in zip(_samples(jlp, jcfg, pi), _samples(tlp, tcfg, pi)):
        for name in ("input_ids", "attention_mask", "splice_idx", "img_gather_idx"):
            np.testing.assert_array_equal(getattr(ts, name), getattr(js, name), err_msg=name)
        assert ts.num_img_tokens == js.num_img_tokens and ts.image_size == js.image_size
        assert ts.family == js.family == "llava" and not hasattr(ts, "crop_grid")
        np.testing.assert_allclose(ts.pixel_values, js.pixel_values, rtol=0, atol=BANK_TOL)


def test_collated_batches_are_the_jax_ones():
    """Anyres samples carry no crop grid: both collators take the f32 path
    and keep full tiles (a two-image row pads the tile axis of the others)."""
    jcfg, tcfg = _configs()
    pi = _prompts_images()
    S = max(len(s.input_ids) for s in _samples(tlp, tcfg, pi)) + 8
    jb = jcollate.collate_samples(_samples(jlp, jcfg, pi), S, 0)
    tb = tcollate.collate_samples(_samples(tlp, tcfg, pi), S, 0)
    assert sorted(tb) == sorted(jb) and "crop_grid" not in tb
    for k in jb:
        if k == "pixel_values":
            np.testing.assert_allclose(tb[k], jb[k], rtol=0, atol=BANK_TOL)
        else:
            np.testing.assert_array_equal(tb[k], jb[k], err_msg=k)
    assert tb["pixel_values"].shape[1] == 2 * (1 + tlp.max_tiles())


# ------------------------------------------------------------ forward / rewards


def _tree(jcfg, jr, seed=0):
    return _np({"backbone": jllava.init_params(jax.random.PRNGKey(seed), jcfg),
                "head": j_init_head(jax.random.PRNGKey(seed + 1), jcfg, jr)})


def _pair_fields(cfg, sizes, seed=0, extra=0):
    """(chosen, rejected) host batches of one wide-image row each (short anyres
    runs), the rejected side left-padded by its shorter prompt."""
    tok = Tok(cfg.text.image_token_id)
    proc = tlp.LlavaNextProcessor(tok, image_token_id=cfg.text.image_token_id,
                                  grid_pinpoints=cfg.grid_pinpoints)
    prompts = ["<image> a red boat on a lake at dawn", "<image> boat"]
    samples = [proc(p, [_image(h, w, seed + i)]) for i, (p, (h, w)) in
               enumerate(zip(prompts, sizes))]
    S = max(len(s.input_ids) for s in samples) + extra
    return [tcollate.collate_samples([s], S, cfg.text.pad_token_id) for s in samples]


def _jb(fields):
    return jcollate.to_reward_batch({k: None if v is None else jnp.asarray(v)
                                     for k, v in fields.items()})


def _tb(fields):
    return tcollate.to_reward_batch(fields, device="cpu")


def _stacked(pairs):
    """Several (chosen, rejected) pairs as one batch, rows chosen0, rejected0, ..."""
    rows = [f for pair in pairs for f in pair]
    S = max(f["input_ids"].shape[1] for f in rows)
    out = {}
    for k in rows[0]:
        parts = []
        for f in rows:
            v = f[k]
            if v is not None and k in ("input_ids", "attention_mask", "splice_idx"):
                pad = S - v.shape[1]
                fill = -1 if k == "splice_idx" else 0
                v = np.pad(v, ((0, 0), (pad, 0)), constant_values=fill)
            parts.append(v)
        out[k] = None if parts[0] is None else np.concatenate(parts)
    return out


def _decisions(r):
    return np.sign(r[0::2, 0] - r[1::2, 0])


def test_tiny_rewards_match_jax():
    """Left-padded pairs through reward_forward and RewardAdaptor.make_score_fn;
    with add_cross_attention set, neither package applies SkipCA to LLaVA:
    the SkipCA weights in the head change no reward."""
    jcfg, tcfg = _configs()
    kw = dict(GPM, add_cross_attention=True, layer_id=jcfg.text.num_layers)
    jr, tr = JRewardConfig(**kw), tconfig.RewardConfig(**kw)
    tree = _tree(jcfg, jr)
    pairs = [_pair_fields(tcfg, [(50, 900), (120, 700)], seed=1),
             _pair_fields(tcfg, [(90, 1000), (60, 800)], seed=3, extra=5)]
    fields = _stacked(pairs)
    assert (fields["attention_mask"] == 0).any(axis=1).sum() >= 2  # left pads
    j = np.asarray(j_reward(jax.tree_util.tree_map(jnp.asarray, tree), jcfg, jr, _jb(fields),
                            training=False, attn_impl="xla").reward)
    tt = to_torch(tree, "cpu")
    t = t_reward(tt, tcfg, tr, _tb(fields)).reward.numpy()
    adaptor = tad.RewardAdaptor(tcfg, tr, tt, model_type="llava", device="cpu")
    ta = adaptor.make_score_fn()(tt, _tb(fields)).numpy()
    assert np.isfinite(t).all() and t.shape == (4, 2)
    np.testing.assert_allclose(t, j, rtol=0, atol=PARITY_BAR)
    np.testing.assert_array_equal(ta, t)
    np.testing.assert_array_equal(_decisions(t), _decisions(j))
    assert "skipca" in tree["head"]
    plain = t_reward(tt, tcfg, dataclasses.replace(tr, add_cross_attention=False),
                     _tb(fields)).reward.numpy()
    np.testing.assert_array_equal(plain, t)


def test_fused_layout_scores_like_the_separate_one():
    """merge_for_scoring fuses q/k/v and gate/up for LLaVA as for qwen."""
    jcfg, tcfg = _configs()
    jr = JRewardConfig(**GPM, layer_id=jcfg.text.num_layers)
    tr = tconfig.RewardConfig(**GPM, layer_id=jcfg.text.num_layers)
    tt = to_torch(_tree(jcfg, jr), "cpu")
    fused = tad.merge_for_scoring(tt["backbone"], "llava")
    assert "qkv_proj" in fused["text"]["layers"] and "q_proj" not in fused["text"]["layers"]
    fields = _stacked([_pair_fields(tcfg, [(50, 900), (120, 700)])])
    a = t_reward(tt, tcfg, tr, _tb(fields)).reward
    b = t_reward({**tt, "backbone": fused}, tcfg, tr, _tb(fields)).reward
    torch.testing.assert_close(b, a, rtol=0, atol=1e-6)


# ------------------------------------------------------------ loading


def _config_json(cfg):
    tc, vc = cfg.text, cfg.vision
    return {"model_type": "llava_next", "image_token_index": tc.image_token_id,
            "image_grid_pinpoints": [list(p) for p in cfg.grid_pinpoints],
            "text_config": {"vocab_size": tc.vocab_size, "hidden_size": tc.hidden_size,
                            "intermediate_size": tc.intermediate_size,
                            "num_hidden_layers": tc.num_layers,
                            "num_attention_heads": tc.num_heads,
                            "num_key_value_heads": tc.num_kv_heads,
                            "rms_norm_eps": tc.rms_norm_eps, "pad_token_id": tc.pad_token_id},
            "vision_config": {"hidden_size": vc.hidden_size,
                              "intermediate_size": vc.intermediate_size,
                              "num_hidden_layers": vc.num_layers,
                              "num_attention_heads": vc.num_heads,
                              "image_size": vc.image_size, "patch_size": vc.patch_size}}


def _write_llava(root, storage):
    """Base checkpoint + artifact (heads, projector x1.5, LoRA r=4 on
    QWEN_TARGETS with b nudged off zero); ``storage`` the on-disk dtype."""
    jcfg = llava_tiny_config()
    rcfg = JRewardConfig(**GPM)
    params = _np(jllava.init_params(jax.random.PRNGKey(0), jcfg))
    base, pm = os.path.join(root, "base"), os.path.join(root, "pm")
    os.makedirs(base)
    j_save_sd(_llava_hf_sd(params, jcfg), os.path.join(base, "pytorch_model.bin"), storage)
    with open(os.path.join(base, "config.json"), "w") as f:
        json.dump(_config_json(jcfg), f)
    head = _np(j_init_head(jax.random.PRNGKey(1), jcfg, rcfg))
    lora = jax.tree_util.tree_map(lambda x: x + 0.02 if x.ndim == 3 else x, _np(
        jlora.init_lora(jax.random.PRNGKey(2), jcfg.text, 4, 8, targets=jlora.QWEN_TARGETS)))
    proj = jax.tree_util.tree_map(lambda x: x * 1.5, params["vision"]["projector"])
    jart.save_reward_artifact(
        pm, rcfg, head, projector_params=proj,
        lora_state=jlora.stacked_to_peft_state(lora, jcfg.text),
        lora_config=jlora.peft_adapter_config(4, 8, 0.05, targets=jlora.QWEN_TARGETS),
        torch_dtype=storage, model_type="llava")
    return jcfg, base, pm


@pytest.fixture(scope="module")
def llava_ckpt(tmp_path_factory):
    """Stored in bf16 (the published checkpoint's dtype), read in f32."""
    return _write_llava(str(tmp_path_factory.mktemp("llava")), torch.bfloat16)


def _assert_trees_close(t, j, tol=TREE_TOL, path=""):
    if isinstance(j, dict):
        assert sorted(t) == sorted(j), path
        for k in j:
            _assert_trees_close(t[k], j[k], tol, f"{path}/{k}")
        return
    j = np.asarray(j)
    assert t.shape == j.shape and t.dtype == j.dtype, path
    if np.issubdtype(j.dtype, np.floating):
        np.testing.assert_allclose(t.astype(np.float64), j.astype(np.float64), rtol=0, atol=tol,
                                   err_msg=path)
    else:
        np.testing.assert_array_equal(t, j, err_msg=path)


@pytest.mark.parametrize("quantize", [None, "w8a8"])
def test_llava_checkpoint_loads_and_scores_alike(llava_ckpt, quantize):
    jcfg, base, pm = llava_ckpt
    kw = dict(quantize=quantize, quantize_min_size=0) if quantize else {}
    ja = jad.load_reward_adaptor(base, pm, model_type="llava", **kw)
    ta = tad.load_reward_adaptor(base, pm, model_type="llava", device="cpu", **kw)
    assert dataclasses.asdict(ta.cfg) == dataclasses.asdict(ja.cfg)
    assert ta.model_type == "llava" and ta.cfg.text.num_layers == 2
    lay = ta.params["backbone"]["text"]["layers"]
    assert "qkv_proj" in lay and "gate_up_proj" in lay  # the fused scoring layout
    if quantize:
        for name in ("qkv_proj", "o_proj", "gate_up_proj", "down_proj"):
            q = lay[name]["kernel"]
            assert is_w8a8(q) and q["qvalues_w8a8"].stride()[-2:] == (
                1, q["qvalues_w8a8"].shape[-2])
    else:
        _assert_trees_close(to_numpy(ta.params), _np(ja.params))
    ja.rcfg.layer_id = ta.rcfg.layer_id = jcfg.text.num_layers
    fields = _stacked([_pair_fields(ta.cfg, [(50, 900), (120, 700)], seed=5),
                       _pair_fields(ta.cfg, [(80, 1000), (40, 600)], seed=7)])
    j = np.asarray(ja.make_score_fn()(ja.params, _jb(fields)))
    t = ta.make_score_fn()(ta.params, _tb(fields)).numpy()
    assert np.isfinite(t).all()
    np.testing.assert_allclose(t, j, rtol=0, atol=W8A8_TOL if quantize else PARITY_BAR)
    np.testing.assert_array_equal(_decisions(t), _decisions(j))


def test_llava_family_is_the_jax_one():
    from llava_reward_tpu.core.registry import get_family as j_family

    t, j = get_family("llava"), j_family("llava")
    for name in ("name", "lora_targets", "projector_path", "supports_skipca"):
        assert getattr(t, name) == getattr(j, name), name
    assert dataclasses.asdict(t.tiny_config()) == dataclasses.asdict(j.tiny_config())
    cfg = tad.llava_config_from_pretrain(MANIFEST)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jad.llava_config_from_pretrain(MANIFEST))
    # the published config is the defaults: llava-v1.6-vicuna-13b
    want = tconfig.LlavaNextConfig()
    assert cfg.text == want.text and cfg.vision == want.vision
    assert cfg.grid_pinpoints == want.grid_pinpoints
    assert dataclasses.asdict(tad.llava_config_from_pretrain(MANIFEST + "-missing")) == \
        dataclasses.asdict(want)


def test_hf_llava_reads_exactly_the_published_keys():
    """The published key list at its depths (40 decoder layers, 24 CLIP
    layers; tiny widths), written by the JAX tests' HF writer from a JAX
    tree: exactly those keys, and the port's strict loader reads them to
    the JAX loader's tree; a dropped or extra key fails; the newer
    'model.language_model.' generation of the same keys loads alike."""
    with open(os.path.join(MANIFEST, "keys.txt")) as f:
        keys = {k.strip() for k in f if k.strip() and not k.startswith("#")}
    kw = dict(num_layers=40, vision_layers=24, hidden_size=32, vision_hidden=16, vocab_size=64)
    jcfg, tcfg = _configs(**kw)
    # the port's init: the same tree layout as the JAX package's, faster at 64 layers
    params = to_numpy(tllava.init_params(tcfg, torch.Generator().manual_seed(0),
                                         torch.float32, "cpu"))
    sd = _llava_hf_sd(params, jcfg)
    sd["language_model.lm_head.weight"] = np.random.default_rng(0).standard_normal(
        (jcfg.text.vocab_size, jcfg.text.hidden_size)).astype(np.float32)
    assert set(sd) == keys, sorted(set(sd) ^ keys)[:5]
    tsd = {k: torch.from_numpy(np.array(v)) for k, v in sd.items()}
    tree = thl.params_from_hf_state_dict(tsd, tcfg, strict=True)
    want = j_llava_params(sd, jcfg)
    assert "lm_head" in tree
    _assert_trees_close(to_numpy(tree), want, tol=0)
    with pytest.raises(KeyError):
        thl.params_from_hf_state_dict(
            {k: v for k, v in tsd.items()
             if k != "language_model.model.layers.7.mlp.up_proj.weight"}, tcfg)
    with pytest.raises(ValueError, match="unconsumed"):
        thl.params_from_hf_state_dict({**tsd, "language_model.model.layers.0.rotary.weight":
                                       torch.zeros(2)}, tcfg)
    renamed = {(k.replace("language_model.model.", "model.language_model.")
                .replace("vision_tower.", "model.vision_tower.")): v for k, v in tsd.items()}
    _assert_trees_close(to_numpy(thl.params_from_hf_state_dict(renamed, tcfg)), want, tol=0)


# ------------------------------------------------------------ training


def _setup_lora():
    jcfg, tcfg = _configs()
    kw = dict(GPM, layer_id=jcfg.text.num_layers)
    jr, tr = JRewardConfig(**kw), tconfig.RewardConfig(**kw)
    tree = _tree(jcfg, jr)
    lora = _np(jlora.init_lora(jax.random.PRNGKey(2), jcfg.text, 4, 8,
                               targets=jlora.QWEN_TARGETS))
    rng = np.random.default_rng(3)
    for t in lora.values():
        t["b"] = rng.standard_normal(t["b"].shape).astype(np.float32) * 0.05
    trainable = {"head": tree["head"], "lora": lora,
                 "projector": tree["backbone"]["vision"]["projector"]}
    return jcfg, tcfg, jr, tr, {"backbone": tree["backbone"]}, trainable


def _paths(tree, prefix=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _paths(v, prefix + (k,))
    elif tree is not None:
        yield prefix, tree


def _get(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def _ttrainable(tree):
    t = to_torch(tree, "cpu")
    for leaf in toptim.tree_leaves(t):
        leaf.requires_grad_(True)
    return t


def test_lora_grads_match_jax():
    """Heads, LoRA on QWEN_TARGETS and the projector trainable over the frozen
    tiny backbone, one left-padded pair, remat on."""
    jcfg, tcfg, jr, tr, frozen, trainable = _setup_lora()
    chosen, rejected = _pair_fields(tcfg, [(50, 900), (120, 700)], seed=1)
    kw = dict(attn_impl="auto", remat=True, projector_path=LLAVA_PATH)
    jfn = jts.make_pairwise_loss_fn(jcfg, jr, **kw)
    tfn = tts.make_pairwise_loss_fn(tcfg, tr, **kw)
    jt = lambda tree: jax.tree_util.tree_map(jnp.asarray, tree)  # noqa: E731
    (jloss, jm), jgrads = jax.jit(jax.value_and_grad(jfn, has_aux=True))(
        jt(trainable), jt(frozen), _jb(chosen), _jb(rejected))
    tt = _ttrainable(trainable)
    tloss, tm = tfn(tt, to_torch(frozen, "cpu"), _tb(chosen), _tb(rejected))
    leaves = toptim.tree_leaves(tt)
    grads = torch.autograd.grad(tloss, leaves, allow_unused=True)
    it = iter(grads)
    tgrads = toptim.tree_map(lambda p: next(it), tt)
    np.testing.assert_allclose(tloss.item(), float(jloss), rtol=LOSS_TOL, atol=LOSS_TOL)
    np.testing.assert_allclose(tm["prob"].item(), float(jm["prob"]), rtol=LOSS_TOL,
                               atol=LOSS_TOL)
    n = 0
    for path, j in _paths(_np(jgrads)):
        t = _get(tgrads, path)
        assert t is not None, path
        bound = GRAD_RTOL * max(np.abs(j).max(), 1e-12)
        err = np.abs(t.detach().numpy() - j).max()
        assert err <= bound, f"{'/'.join(path)}: max err {err:.3e} > {bound:.3e}"
        n += 1
    assert n == len(leaves)
    assert set(tgrads["lora"]) == set(QWEN_TARGETS)
    for name in QWEN_TARGETS:
        assert float(tgrads["lora"][name]["a"].abs().max()) > 0, name
    assert float(tgrads["projector"]["fc1"]["kernel"].abs().max()) > 0


def test_fp32_projector_over_a_bf16_backbone_trains():
    """The card's layout: bf16 backbone, fp32 heads, LoRA and projector; the
    projector's products promote as ``jnp`` does (ops/linear.mm), so a step
    runs and every trainable leaf keeps its dtype and stays finite."""
    _, tcfg, _, tr, frozen, trainable = _setup_lora()
    frozen = toptim.tree_map(lambda t: t.to(torch.bfloat16), to_torch(frozen, "cpu"))
    tt = to_torch(trainable, "cpu")
    chosen, rejected = map(_tb, _pair_fields(tcfg, [(50, 900), (120, 700)], seed=1))
    tx = toptim.make_optimizer(1e-3, 10)
    step = tts.make_train_step(tts.make_pairwise_loss_fn(tcfg, tr, projector_path=LLAVA_PATH),
                               tx)
    state = tts.init_train_state(tt, tx)
    for _ in range(2):
        state, m = step(state, frozen, chosen, rejected)
    assert np.isfinite(m["preference_loss"].item()) and m["grad_norm"].item() > 0
    for (path, new), (_, old) in zip(_paths(state.trainable), _paths(tt)):
        assert new.dtype == old.dtype == torch.float32 and bool(torch.isfinite(new).all()), path
    assert not torch.equal(state.trainable["projector"]["fc1"]["kernel"],
                           tt["projector"]["fc1"]["kernel"])
