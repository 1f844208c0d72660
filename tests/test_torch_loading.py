"""Checkpoint loading in the port against the JAX package: synthetic base
checkpoints (HF key layout) and reward artifacts (heads, projector, PEFT
adapters on the decoder, the CLIP tower and the projector) at tiny configs,
written to ``tmp_path`` as the JAX tests write them
(tests/test_artifact_io.py:100-151, test_qwen_adaptor.py,
test_strict_loading.py, test_quantize_and_vision_lora.py:339-400).

- both packages load the same directory to the same tree and score the same
  batch: stored in bf16 or f32, read in f32, rewards within 2.03e-05; with
  ``quantize="w8a8"`` within 2e-3 (the bound of
  tests/test_torch_quant_kernels.py: XLA's rsqrt and summation order flip an
  int8 code near a rounding boundary now and then), same decisions;
- a dropped or an extra key fails in both;
- the configs parsed from ``tools/manifests/*/config.json`` are equal;
- the port's loaders consume exactly ``keys.txt`` (as
  tools/check_key_manifest.py audits the JAX ones), on meta tensors;
- a full fine-tuned export of the port's trainer loads in the JAX package,
  and the full-checkpoint mode (pretrain == the artifact) loads in the port.
"""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

import jax

from llava_reward_tpu.core.config import RewardConfig as JRewardConfig
from llava_reward_tpu.core.config import phi3v_tiny_config, qwen_tiny_config
from llava_reward_tpu.evalx import adaptor as jad
from llava_reward_tpu.io import artifact as jart
from llava_reward_tpu.io.hf_phi3v import hf_state_dict_from_params as j_hf_sd
from llava_reward_tpu.io.torch_io import load_torch_state_dict as j_load_sd
from llava_reward_tpu.io.torch_io import save_torch_state_dict as j_save_sd
from llava_reward_tpu.lora import lora as jlora
from llava_reward_tpu.models import phi3v as jphi3v
from llava_reward_tpu.models import qwen25_vl as jqwen
from llava_reward_tpu.reward.model import RewardBatch as JBatch
from llava_reward_tpu.reward.model import init_head_params as j_init_head
from llava_reward_torch.core import config as tconfig
from llava_reward_torch.evalx import adaptor as tad
from llava_reward_torch.io import hf_phi3v as thf
from llava_reward_torch.io import hf_qwen as thq
from llava_reward_torch.io.convert import to_numpy, to_torch
from llava_reward_torch.io.torch_io import load_torch_state_dict as t_load_sd
from llava_reward_torch.io.torch_io import save_torch_state_dict as t_save_sd
from llava_reward_torch.models import phi3v as tphi3v
from llava_reward_torch.models import qwen25_vl as tqwen
from llava_reward_torch.preprocess import collate as tcollate
from llava_reward_torch.preprocess import qwen_vision as tqv
from llava_reward_torch.reward.model import RewardBatch as TBatch
from llava_reward_torch.train import optim as toptim
from llava_reward_torch.train import train_step as tts
from llava_reward_torch.train.trainer import RewardTrainer
from llava_reward_torch.utils.quantize import is_w8a8
from test_qwen_adaptor import _qwen_hf_sd
from test_torch_processor import QTok, synthetic
from test_torch_reward import N_IMG, PARITY_BAR, _batch, _jb, _tb

W8A8_TOL = 2e-3
TREE_TOL = 1e-6  # the LoRA merge sums in another order
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MANIFESTS = os.path.join(ROOT, "tools", "manifests")
RCFG = dict(is_general_preference=True, value_head_dim=2, add_cross_attention=True)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, jax.device_get(tree))


def _phi3v_config_json(cfg):
    d = cfg.decoder
    return {"model_type": "phi3_v", "vocab_size": d.vocab_size, "hidden_size": d.hidden_size,
            "intermediate_size": d.intermediate_size, "num_hidden_layers": d.num_layers,
            "num_attention_heads": d.num_heads, "num_key_value_heads": d.num_kv_heads,
            "pad_token_id": d.pad_token_id, "eos_token_id": d.eos_token_id}


def _write_phi3v(root, storage):
    """Base checkpoint + artifact; ``storage`` the on-disk float dtype."""
    cfg = phi3v_tiny_config(num_layers=2, vision_layers=2)
    rcfg = JRewardConfig(**RCFG)
    params = _np(jphi3v.init_params(jax.random.PRNGKey(0), cfg))
    base, pm = os.path.join(root, "base"), os.path.join(root, "pm")
    os.makedirs(base)
    j_save_sd(j_hf_sd(params, cfg), os.path.join(base, "pytorch_model.bin"), storage)
    with open(os.path.join(base, "config.json"), "w") as f:
        json.dump(_phi3v_config_json(cfg), f)
    head = _np(j_init_head(jax.random.PRNGKey(1), cfg, rcfg))
    nudge = lambda x: x + 0.02 if x.ndim == 3 else x  # noqa: E731  (b = 0 merges nothing)
    lora = jax.tree_util.tree_map(nudge, _np(jlora.init_lora(jax.random.PRNGKey(2), cfg.decoder,
                                                             4, 8)))
    vlora = jax.tree_util.tree_map(nudge, _np(jlora.init_vision_lora(
        jax.random.PRNGKey(3), cfg.vision, 4, 8)))
    state = {**jlora.stacked_to_peft_state(lora, cfg.decoder),
             **jlora.vision_stacked_to_peft_state(vlora, cfg.vision)}
    rng = np.random.default_rng(4)
    for idx, fc in (("0", "fc1"), ("2", "fc2")):  # the projector's own adapter
        n_in, n_out = params["vision"]["img_projection"][fc]["kernel"].shape
        pre = f"base_model.model.model.vision_embed_tokens.img_projection.{idx}"
        state[f"{pre}.lora_A.weight"] = rng.standard_normal((4, n_in)).astype(np.float32) * 0.1
        state[f"{pre}.lora_B.weight"] = rng.standard_normal((n_out, 4)).astype(np.float32) * 0.1
    proj = jax.tree_util.tree_map(lambda x: x * 1.5, params["vision"]["img_projection"])
    jart.save_reward_artifact(pm, rcfg, head, projector_params=proj, lora_state=state,
                              lora_config=jlora.peft_adapter_config(4, 8, 0.05),
                              torch_dtype=storage)
    return cfg, base, pm


@pytest.fixture(scope="module", params=[torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def phi3v_ckpt(request, tmp_path_factory):
    return _write_phi3v(str(tmp_path_factory.mktemp("phi3v")), request.param)


@pytest.fixture(scope="module")
def phi3v_bf16(tmp_path_factory):
    """The bf16 checkpoint alone, for the tests the storage dtype does not move."""
    return _write_phi3v(str(tmp_path_factory.mktemp("phi3v_bf16")), torch.bfloat16)


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


def _score(jadaptor, tadaptor, fields):
    j = np.asarray(jadaptor.make_score_fn()(jadaptor.params, _jb(fields)))
    t = tadaptor.make_score_fn()(tadaptor.params, _tb(fields)).numpy()
    return j, t


def _decisions(r):
    return np.sign(r[0::2, 0] - r[1::2, 0])


def test_phi3v_checkpoint_loads_and_scores_alike(phi3v_ckpt):
    cfg, base, pm = phi3v_ckpt
    ja = jad.load_reward_adaptor(base, pm)
    ta = tad.load_reward_adaptor(base, pm, device="cpu")
    assert dataclasses.asdict(ta.cfg) == dataclasses.asdict(ja.cfg)
    assert ta.rcfg.to_contract_dict() == ja.rcfg.to_contract_dict()
    _assert_trees_close(to_numpy(ta.params), _np(ja.params))
    ja.rcfg.layer_id = ta.rcfg.layer_id = cfg.decoder.num_layers
    fields = _batch(ja.cfg, [0, 25, 0, 7], [N_IMG, N_IMG - 40, N_IMG, N_IMG - 3])
    j, t = _score(ja, ta, fields)
    assert np.isfinite(t).all()
    np.testing.assert_allclose(t, j, rtol=0, atol=PARITY_BAR)
    np.testing.assert_array_equal(_decisions(t), _decisions(j))


def test_phi3v_w8a8_load_scores_alike(phi3v_ckpt):
    cfg, base, pm = phi3v_ckpt
    kw = dict(quantize="w8a8", quantize_min_size=0)
    ja = jad.load_reward_adaptor(base, pm, **kw)
    ta = tad.load_reward_adaptor(base, pm, device="cpu", **kw)
    lay = ta.params["backbone"]["decoder"]["layers"]
    for name in ("qkv_proj", "o_proj", "gate_up_proj", "down_proj"):
        assert is_w8a8(lay[name]) and lay[name]["qvalues_w8a8"].stride()[-2:] == (
            1, lay[name]["qvalues_w8a8"].shape[-2])
    assert not is_w8a8(ta.params["backbone"]["vision"]["clip"]["layers"]["mlp"]["fc1"]["kernel"])
    ja.rcfg.layer_id = ta.rcfg.layer_id = cfg.decoder.num_layers
    fields = _batch(ja.cfg, [0, 25], [N_IMG, N_IMG - 40], seed=1)
    j, t = _score(ja, ta, fields)
    np.testing.assert_allclose(t, j, rtol=0, atol=W8A8_TOL)
    np.testing.assert_array_equal(_decisions(t), _decisions(j))
    # bf16 compute with the codes kept
    tb = tad.load_reward_adaptor(base, pm, device="cpu", compute_dtype=torch.bfloat16, **kw)
    layb = tb.params["backbone"]["decoder"]["layers"]
    assert layb["qkv_proj"]["qvalues_w8a8"].dtype == torch.int8
    assert layb["qkv_proj"]["scale"].dtype == torch.float32
    assert layb["input_layernorm"].dtype == torch.bfloat16


def _tamper(src_dir, dst_dir, fn):
    os.makedirs(dst_dir)
    sd = j_load_sd(os.path.join(src_dir, "pytorch_model.bin"))
    fn(sd)
    j_save_sd(sd, os.path.join(dst_dir, "pytorch_model.bin"), torch.float32)
    if os.path.exists(os.path.join(src_dir, "config.json")):
        with open(os.path.join(src_dir, "config.json")) as f, \
                open(os.path.join(dst_dir, "config.json"), "w") as g:
            g.write(f.read())


def test_strict_loading_refuses_in_both(phi3v_bf16, tmp_path):
    _, base, pm = phi3v_bf16
    dropped, extra = str(tmp_path / "dropped"), str(tmp_path / "extra")
    _tamper(base, dropped, lambda sd: sd.pop("model.layers.1.mlp.down_proj.weight"))
    _tamper(base, extra, lambda sd: sd.update({"model.layers.0.self_attn.rotary.weight":
                                               np.zeros(3, np.float32)}))
    for load, kw in ((jad.load_reward_adaptor, {}), (tad.load_reward_adaptor,
                                                     {"device": "cpu"})):
        with pytest.raises(KeyError, match="down_proj"):
            load(dropped, pm, **kw)
        with pytest.raises(ValueError, match="rotary"):
            load(extra, pm, **kw)
        load(extra, pm, strict=False, **kw)  # downgraded to a warning
    # a stray key in the artifact, and an adapter key no merge consumes
    for name, fn in (("pm_extra", lambda sd: sd.update({"stray.weight": np.zeros(2, np.float32)})),
                     ("pm_lora", None)):
        bad = str(tmp_path / name)
        _tamper(pm, bad, fn or (lambda sd: None))
        with open(os.path.join(pm, "reward_config.yaml")) as f, \
                open(os.path.join(bad, "reward_config.yaml"), "w") as g:
            g.write(f.read())
        if fn is None:
            os.makedirs(os.path.join(bad, "lora"))
            lsd = j_load_sd(os.path.join(pm, "lora", "adapter_model.bin"))
            lsd["base_model.model.model.layers.0.mlp.mystery.lora_A.weight"] = np.zeros(
                (4, 8), np.float32)
            j_save_sd(lsd, os.path.join(bad, "lora", "adapter_model.bin"), torch.float32)
            with open(os.path.join(pm, "lora", "adapter_config.json")) as f, \
                    open(os.path.join(bad, "lora", "adapter_config.json"), "w") as g:
                g.write(f.read())
        for load, kw in ((jad.load_reward_adaptor, {}), (tad.load_reward_adaptor,
                                                         {"device": "cpu"})):
            with pytest.raises(ValueError, match="stray" if fn else "mystery"):
                load(base, bad, **kw)


def _qwen_config_json(cfg):
    tc, vc = cfg.text, cfg.vision
    return {"model_type": "qwen2_5_vl", "vocab_size": tc.vocab_size,
            "hidden_size": tc.hidden_size, "intermediate_size": tc.intermediate_size,
            "num_hidden_layers": tc.num_layers, "num_attention_heads": tc.num_heads,
            "num_key_value_heads": tc.num_kv_heads, "rms_norm_eps": tc.rms_norm_eps,
            "rope_theta": tc.rope_theta,
            "rope_scaling": {"type": "mrope", "mrope_section": list(tc.mrope_section)},
            "image_token_id": tc.image_token_id, "pad_token_id": tc.pad_token_id,
            "vision_config": {"depth": vc.depth, "hidden_size": vc.hidden_size,
                              "intermediate_size": vc.intermediate_size,
                              "num_heads": vc.num_heads, "out_hidden_size": vc.out_hidden_size,
                              "fullatt_block_indexes": list(vc.fullatt_block_indexes)}}


@pytest.fixture(scope="module")
def qwen_ckpt(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("qwen"))
    cfg = qwen_tiny_config(num_layers=2, vision_depth=2)
    rcfg = JRewardConfig(**RCFG)
    params = _np(jqwen.init_params(jax.random.PRNGKey(0), cfg))
    base, pm = os.path.join(root, "base"), os.path.join(root, "pm")
    os.makedirs(base)
    j_save_sd(_qwen_hf_sd(params, cfg), os.path.join(base, "pytorch_model.bin"), torch.bfloat16)
    with open(os.path.join(base, "config.json"), "w") as f:
        json.dump(_qwen_config_json(cfg), f)
    head = _np(j_init_head(jax.random.PRNGKey(1), cfg, rcfg))
    lora = jax.tree_util.tree_map(lambda x: x + 0.02 if x.ndim == 3 else x, _np(
        jlora.init_lora(jax.random.PRNGKey(2), cfg.text, 4, 8, targets=jlora.QWEN_TARGETS)))
    merger = jax.tree_util.tree_map(lambda x: x * 1.25, params["visual"]["merger"])
    jart.save_reward_artifact(pm, rcfg, head, projector_params=merger,
                              lora_state=jlora.stacked_to_peft_state(lora, cfg.text),
                              lora_config=jlora.peft_adapter_config(4, 8, 0.05,
                                                                    targets=jlora.QWEN_TARGETS),
                              torch_dtype=torch.float32, model_type="qwen")
    return cfg, base, pm


def _qwen_fields(cfg, seed):
    tok = None
    proc = tqv.Qwen25VLProcessor(tok, min_pixels=4 * 28 * 28, max_pixels=16 * 28 * 28,
                                 image_token_id=cfg.text.image_token_id)
    tok_ids = lambda text: [cfg.text.image_token_id if w == "<img>" else  # noqa: E731
                            sum(map(ord, w)) % 300 + 10 for w in text.split()]
    proc.tokenizer = tok_ids
    samples = [proc(f"a {w} picture <img> of it", [synthetic(w, h, seed + i)])
               for i, (w, h) in enumerate(((120, 90), (64, 140), (100, 100), (150, 60)))]
    b = tcollate.collate_qwen_samples(samples, 48, cfg.text.pad_token_id, 128, 16)
    return tuple(b[f] for f in ("input_ids", "attention_mask", "pixel_values", "img_gather_idx",
                                "splice_idx", "num_img_tokens", "position_ids", "patch_valid",
                                "rot_pos", "unit_gather"))


@pytest.mark.parametrize("quantize", [None, "w8a8"])
def test_qwen_checkpoint_loads_and_scores_alike(qwen_ckpt, quantize):
    cfg, base, pm = qwen_ckpt
    kw = dict(model_type="qwen", quantize=quantize, quantize_min_size=0)
    ja = jad.load_reward_adaptor(base, pm, **kw)
    ta = tad.load_reward_adaptor(base, pm, device="cpu", **kw)
    assert dataclasses.asdict(ta.cfg) == dataclasses.asdict(ja.cfg)
    if quantize is None:
        _assert_trees_close(to_numpy(ta.params), _np(ja.params))
    lay = ta.params["backbone"]["text"]["layers"]
    assert "qkv_proj" in lay and "q_proj" not in lay  # the fused scoring layout
    ja.rcfg.layer_id = ta.rcfg.layer_id = cfg.text.num_layers
    fields = _qwen_fields(ta.cfg, 30)
    j = np.asarray(ja.make_score_fn()(ja.params, JBatch(*[None if f is None else jax.numpy.asarray(
        f) for f in fields])))
    t = ta.make_score_fn()(ta.params, TBatch(*[None if f is None else torch.from_numpy(f)
                                               for f in fields])).numpy()
    np.testing.assert_allclose(t, j, rtol=0, atol=W8A8_TOL if quantize else PARITY_BAR)
    np.testing.assert_array_equal(_decisions(t), _decisions(j))


def test_qwen_strict_loading_refuses_in_both(qwen_ckpt, tmp_path):
    _, base, pm = qwen_ckpt
    dropped, extra = str(tmp_path / "dropped"), str(tmp_path / "extra")
    _tamper(base, dropped, lambda sd: sd.pop("visual.blocks.1.mlp.up_proj.bias"))
    _tamper(base, extra, lambda sd: sd.update({"visual.blocks.0.attn.extra.weight":
                                               np.zeros(3, np.float32)}))
    for load, kw in ((jad.load_reward_adaptor, {}), (tad.load_reward_adaptor, {"device": "cpu"})):
        with pytest.raises(KeyError, match="up_proj"):
            load(dropped, pm, model_type="qwen", **kw)
        with pytest.raises(ValueError, match="attn.extra"):
            load(extra, pm, model_type="qwen", **kw)


@pytest.mark.parametrize("name", ["phi35_vision_instruct", "qwen25_vl_7b_instruct"])
def test_configs_from_the_published_config_json(name):
    d = os.path.join(MANIFESTS, name)
    fn = "phi3v_config_from_pretrain" if name.startswith("phi") else "qwen_config_from_pretrain"
    t, j = getattr(tad, fn)(d), getattr(jad, fn)(d)
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    with open(os.path.join(d, "config.json")) as f:
        cj = json.load(f)
    if name.startswith("phi"):
        assert dataclasses.asdict(tad.decoder_config_from_hf_json(cj)) == dataclasses.asdict(
            jad.decoder_config_from_hf_json(cj))
        assert t.decoder.rope_scaling is not None and t.decoder.num_layers == 32
    # no config.json: the full-size defaults
    assert dataclasses.asdict(getattr(tad, fn)(str(d) + "-missing")) == dataclasses.asdict(
        getattr(jad, fn)(str(d) + "-missing"))


def _meta_shapes_phi3v(cfg):
    tree = tphi3v.init_params(cfg, torch.Generator(), torch.float32, "meta")
    d, v = cfg.decoder, cfg.vision
    c = thf._CLIP_PREFIX
    shapes = {"model.embed_tokens.weight": (d.vocab_size, d.hidden_size),
              "model.vision_embed_tokens.wte.weight": (d.vocab_size, d.hidden_size),
              "model.norm.weight": (d.hidden_size,),
              "lm_head.weight": (d.vocab_size, d.hidden_size),
              "model.vision_embed_tokens.glb_GN": (1, 1, cfg.merged_feature_dim),
              "model.vision_embed_tokens.sub_GN": (1, 1, 1, cfg.merged_feature_dim),
              f"{c}.embeddings.class_embedding": (v.hidden_size,),
              f"{c}.embeddings.patch_embedding.weight": (v.hidden_size, v.num_channels,
                                                          v.patch_size, v.patch_size),
              f"{c}.embeddings.position_embedding.weight": (v.num_positions, v.hidden_size),
              f"{c}.embeddings.position_ids": (1, v.num_positions)}
    for norm in ("pre_layrnorm", "post_layernorm"):
        for part in ("weight", "bias"):
            shapes[f"{c}.{norm}.{part}"] = (v.hidden_size,)
    for i, fc in ((0, "fc1"), (2, "fc2")):
        k = tree["vision"]["img_projection"][fc]["kernel"]
        shapes[f"model.vision_embed_tokens.img_projection.{i}.weight"] = k.T.shape
        shapes[f"model.vision_embed_tokens.img_projection.{i}.bias"] = k.shape[1:]
    for i in range(d.num_layers):
        for name, leaf in tree["decoder"]["layers"].items():
            sub = (name if "layernorm" in name else
                   f"self_attn.{name}" if name in ("qkv_proj", "o_proj") else f"mlp.{name}")
            shapes[f"model.layers.{i}.{sub}.weight"] = tuple(reversed(leaf[i].shape))
    cl = tree["vision"]["clip"]["layers"]
    subs = {**{f"layer_norm{n}": cl[f"ln{n}"] for n in (1, 2)},
            **{f"self_attn.{p}": cl["attn"][a] for a, p in thf._CLIP_ATTN},
            **{f"mlp.{fc}": cl["mlp"][fc] for fc in ("fc1", "fc2")}}
    for i in range(v.num_layers):
        for sub, leaf in subs.items():
            w = leaf["weight"] if "weight" in leaf else leaf["kernel"]
            shapes[f"{c}.encoder.layers.{i}.{sub}.weight"] = tuple(reversed(w[i].shape))
            shapes[f"{c}.encoder.layers.{i}.{sub}.bias"] = leaf["bias"][i].shape
    return tree, shapes


def _meta_shapes_qwen(cfg):
    tree = tqwen.init_params(cfg, torch.Generator(), torch.float32, "meta")
    vc, tc = cfg.vision, cfg.text
    shapes = {"visual.patch_embed.proj.weight": (vc.hidden_size, 3, vc.temporal_patch_size,
                                                 vc.patch_size, vc.patch_size),
              "visual.merger.ln_q.weight": (vc.hidden_size,),
              "model.embed_tokens.weight": (tc.vocab_size, tc.hidden_size),
              "model.norm.weight": (tc.hidden_size,),
              "lm_head.weight": (tc.vocab_size, tc.hidden_size)}
    for i, fc in ((0, "fc1"), (2, "fc2")):
        k = tree["visual"]["merger"][fc]["kernel"]
        shapes[f"visual.merger.mlp.{i}.weight"] = k.T.shape
        shapes[f"visual.merger.mlp.{i}.bias"] = k.shape[1:]

    def add(prefix, n, sub, leaf):
        for i in range(n):
            if isinstance(leaf, dict):
                shapes[f"{prefix}.{i}.{sub}.weight"] = leaf["kernel"][i].T.shape
                if "bias" in leaf:
                    shapes[f"{prefix}.{i}.{sub}.bias"] = leaf["bias"][i].shape
            else:
                shapes[f"{prefix}.{i}.{sub}.weight"] = leaf[i].shape

    b, lay = tree["visual"]["blocks"], tree["text"]["layers"]
    for sub, leaf in (("norm1", b["norm1"]), ("norm2", b["norm2"]), ("attn.qkv", b["qkv"]),
                      ("attn.proj", b["proj"]), *[(f"mlp.{n}_proj", b["mlp"][n])
                                                  for n in ("gate", "up", "down")]):
        add("visual.blocks", vc.depth, sub, leaf)
    for name, leaf in lay.items():
        sub = (name if "layernorm" in name else
               f"self_attn.{name}" if name[0] in "qkvo" else f"mlp.{name}")
        add("model.layers", tc.num_layers, sub, leaf)
    return tree, shapes


@pytest.mark.parametrize("name", ["phi35_vision_instruct", "qwen25_vl_7b_instruct"])
def test_loaders_consume_exactly_the_published_keys(name):
    """The published key list, as meta tensors of the config's shapes, goes
    through the port's strict loader: every key is read, none is missing,
    and the tree has the layout of ``init_params``."""
    d = os.path.join(MANIFESTS, name)
    with open(os.path.join(d, "keys.txt")) as f:
        keys = [k.strip() for k in f if k.strip() and not k.startswith("#")]
    phi = name.startswith("phi")
    cfg = (tad.phi3v_config_from_pretrain if phi else tad.qwen_config_from_pretrain)(d)
    init, shapes = (_meta_shapes_phi3v if phi else _meta_shapes_qwen)(cfg)
    assert not set(keys) - set(shapes), sorted(set(keys) - set(shapes))[:5]
    sd = {k: torch.empty(shapes[k], device="meta") for k in keys}
    load = thf.params_from_hf_state_dict if phi else thq.params_from_hf_state_dict
    if phi:
        cfg = tad._infer_vision_geometry(cfg, sd)
    tree = load(sd, cfg, strict=True)
    init["lm_head"] = tree["lm_head"]
    assert jax.tree_util.tree_structure(jax.tree_util.tree_map(lambda x: 0, tree)) == \
        jax.tree_util.tree_structure(jax.tree_util.tree_map(lambda x: 0, init))
    for a, b in zip(jax.tree_util.tree_leaves(tree), jax.tree_util.tree_leaves(init)):
        assert tuple(a.shape) == tuple(b.shape)
    with pytest.raises(KeyError):
        load({k: v for k, v in sd.items() if k != keys[len(keys) // 2]}, cfg, strict=True)
    with pytest.raises(ValueError, match="unconsumed"):
        load({**sd, "model.layers.0.self_attn.rotary.weight": torch.empty(2, device="meta")},
             cfg, strict=True)


def test_full_finetune_export_loads_in_both(tmp_path):
    """The port's trainer under full fine-tuning writes ``full_model/``; the
    JAX package and the port load it (and the full-checkpoint mode, the
    artifact's .bin holding backbone and heads together, loads in the port)."""
    jcfg = phi3v_tiny_config(num_layers=2, vision_layers=2)
    tcfg = tconfig.phi3v_tiny_config(num_layers=2, vision_layers=2)
    kw = dict(is_general_preference=True, value_head_dim=2, layer_id=2)
    jr, tr = JRewardConfig(**kw), tconfig.RewardConfig(**kw)
    backbone = _np(jphi3v.init_params(jax.random.PRNGKey(0), jcfg))
    lm_head = np.random.default_rng(1).standard_normal((64, 512)).astype(np.float32)
    head = _np(j_init_head(jax.random.PRNGKey(1), jcfg, jr))
    trainable = to_torch({"head": head, "backbone": backbone}, "cpu")
    trainer = RewardTrainer(
        cfg=tcfg, rcfg=tr, frozen={"backbone": to_torch({"lm_head": lm_head}, "cpu")},
        trainable=trainable, tx=toptim.make_optimizer(1e-3, 10, warmup_ratio=0.0),
        loss_fn=tts.make_pairwise_loss_fn(tcfg, tr, remat=False), train_loader=[],
        save_path=str(tmp_path / "out"), device="cpu")
    path = str(tmp_path / "art")
    trainer.save_artifact(path)
    full = os.path.join(path, "full_model")
    sd = t_load_sd(full)
    assert sd["lm_head.weight"].dtype == torch.bfloat16
    np.testing.assert_array_equal(sd["lm_head.weight"].float().numpy(),
                                  torch.from_numpy(lm_head.T).bfloat16().float().numpy())
    bf16 = lambda x: torch.tensor(np.asarray(x)).bfloat16().float().numpy()  # noqa: E731
    ja = jad.load_reward_adaptor(full, path, ft_projector=False)
    ta = tad.load_reward_adaptor(full, path, ft_projector=False, device="cpu")
    want = jax.tree_util.tree_map(bf16, backbone)
    _assert_trees_close(_np(ja.params["backbone"]), {**want, "lm_head": bf16(lm_head)}, 0.0)
    _assert_trees_close(to_numpy(ta.params["backbone"]), {**want, "lm_head": bf16(lm_head)}, 0.0)
    assert dataclasses.asdict(ta.cfg) == dataclasses.asdict(ja.cfg)

    # full-checkpoint mode: backbone and head keys in one .bin, pretrain == pm_path
    ft = str(tmp_path / "ft")
    os.makedirs(ft)
    one = {**sd, "value_head.weight": np.ascontiguousarray(head["value_head"]["kernel"].T)}
    t_save_sd(one, os.path.join(ft, "pytorch_model.bin"), torch.float32)
    for name in ("config.json",):
        with open(os.path.join(full, name)) as f, open(os.path.join(ft, name), "w") as g:
            g.write(f.read())
    with open(os.path.join(path, "reward_config.yaml")) as f, \
            open(os.path.join(ft, "reward_config.yaml"), "w") as g:
        g.write(f.read())
    for load, kw in ((jad.load_reward_adaptor, {}), (tad.load_reward_adaptor, {"device": "cpu"})):
        a = load(ft, ft, ft_projector=False, **kw)
        got = a.params["head"]["value_head"]["kernel"]
        got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
        np.testing.assert_allclose(got, head["value_head"]["kernel"], rtol=1e-6)


def test_qwen_writer_is_the_jax_tests_layout():
    """The port's qwen HF writer (used by chip_smoke.py's [load] phase) gives
    the state dict of the JAX tests' writer, and reads back to the tree."""
    cfg = qwen_tiny_config(num_layers=2, vision_depth=2)
    params = _np(jqwen.init_params(jax.random.PRNGKey(5), cfg))
    want = _qwen_hf_sd(params, cfg)
    got = thq.hf_state_dict_from_params(to_torch(params, "cpu"), tconfig.qwen_tiny_config(
        num_layers=2, vision_depth=2))
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), want[k], err_msg=k)
    back = thq.params_from_hf_state_dict(got, tconfig.qwen_tiny_config(num_layers=2,
                                                                       vision_depth=2))
    _assert_trees_close(to_numpy(back), params, 0.0)


@pytest.mark.parametrize("quantize", ["int8", "int4", "nf4"])
def test_weight_only_loads_score_alike(phi3v_bf16, quantize):
    """--load_in_4bit and the int8 weight-only scheme: the decoder's large
    leaves quantized after the merge in both packages, the CLIP tower not."""
    cfg, base, pm = phi3v_bf16
    kw = dict(quantize=quantize, quantize_min_size=0)
    ja = jad.load_reward_adaptor(base, pm, **kw)
    ta = tad.load_reward_adaptor(base, pm, device="cpu", **kw)
    lay = ta.params["backbone"]["decoder"]["layers"]
    assert all(isinstance(lay[n], dict) for n in ("qkv_proj", "o_proj", "gate_up_proj",
                                                  "down_proj"))
    _assert_trees_close(to_numpy(lay), _np(ja.params["backbone"]["decoder"]["layers"]))
    ja.rcfg.layer_id = ta.rcfg.layer_id = cfg.decoder.num_layers
    j, t = _score(ja, ta, _batch(ja.cfg, [0, 25], [N_IMG, N_IMG - 40], seed=2))
    np.testing.assert_allclose(t, j, rtol=0, atol=W8A8_TOL)
    np.testing.assert_array_equal(_decisions(t), _decisions(j))


def test_load_defaults_to_the_card(phi3v_bf16):
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA; the default device is valid here")
    _, base, pm = phi3v_bf16
    with pytest.raises(RuntimeError, match="cuda"):
        tad.load_reward_adaptor(base, pm)


def test_registry_matches_jax(monkeypatch):
    from llava_reward_tpu.core.registry import get_family as j_family
    from llava_reward_torch.core.registry import get_family as t_family

    for name in ("phi3v", "qwen"):
        t, j = t_family(name), j_family(name)
        for field in ("name", "lora_targets", "projector_path", "supports_skipca"):
            assert getattr(t, field) == getattr(j, field), (name, field)
        assert dataclasses.asdict(t.tiny_config()) == dataclasses.asdict(j.tiny_config())
        assert t.params_from_sd.__module__.startswith("llava_reward_torch")
        cfg = t.tiny_config()
        for env, want in (("1", True), ("0", False)):
            monkeypatch.setenv("LRT_DEVICE_PREPROC", env)
            assert t.make_processor(QTok(), cfg).device_preproc is want
            assert j.make_processor(QTok(), j.tiny_config()).device_preproc is want
        monkeypatch.delenv("LRT_DEVICE_PREPROC")
        assert t.make_processor(QTok(), cfg).device_preproc is True
    t, j = t_family("llava"), j_family("llava")  # LLaVA-NeXT: tests/test_torch_llava.py
    for field in ("name", "lora_targets", "projector_path", "supports_skipca"):
        assert getattr(t, field) == getattr(j, field), ("llava", field)
    with pytest.raises(ValueError, match="unknown model_type"):
        t_family("gpt")
