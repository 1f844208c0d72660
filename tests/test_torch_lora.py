"""The port's LoRA module against the JAX package's, on the CPU: the merge
(decoder and CLIP), the PEFT adapter dicts both ways bit for bit, the
inline LoRA forward against the merged forward, and the initialisers'
shapes, bounds and tree layout. One stacked tree (JAX init, made nonzero in
``b``) carried across by ``io/convert.py`` feeds both. The same for
Qwen2.5-VL's ``QWEN_TARGETS`` on its separate ``{'kernel', 'bias'}`` leaves,
and the merged tree fused into the inference layout against the inline LoRA
forward.

Tolerances: merges TOL (fp32 einsum in two libraries); inline vs merged
forward FWD_TOL (x@a@b*scale against x@(W + a@b*scale) in fp32).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llava_reward_tpu.core.config import phi3v_tiny_config, qwen_tiny_config
from llava_reward_tpu.lora import lora as jlora
from llava_reward_tpu.models import phi3v as jphi3v
from llava_reward_tpu.models import qwen25_vl as jqwen
from llava_reward_torch.core import config as tconfig
from llava_reward_torch.io.convert import to_numpy, to_torch
from llava_reward_torch.lora import lora as tlora
from llava_reward_torch.models import clip_vit as tclip
from llava_reward_torch.models import phi3 as tphi3
from llava_reward_torch.models import qwen25_vl as tqwen

TOL = 1e-6
FWD_TOL = 2e-5


def _nonzero_b(tree, seed):
    rng = np.random.default_rng(seed)
    out = jax.tree_util.tree_map(np.asarray, tree)
    for t in out.values():
        t["b"] = rng.standard_normal(t["b"].shape).astype(np.float32) * 0.05
    return out


@pytest.fixture(scope="module")
def tiny():
    jcfg = phi3v_tiny_config()
    backbone = jax.tree_util.tree_map(np.asarray, jphi3v.init_params(jax.random.PRNGKey(0), jcfg))
    lora = _nonzero_b(jlora.init_lora(jax.random.PRNGKey(1), jcfg.decoder, 4, 8), 1)
    vlora = _nonzero_b(jlora.init_vision_lora(jax.random.PRNGKey(2), jcfg.vision, 4, 8), 2)
    return jcfg, tconfig.phi3v_tiny_config(), backbone, lora, vlora


def test_merge_lora_matches_jax(tiny):
    jcfg, tcfg, backbone, lora, _ = tiny
    layers = backbone["decoder"]["layers"]
    j = jlora.merge_lora(jax.tree_util.tree_map(jnp.asarray, layers),
                         jax.tree_util.tree_map(jnp.asarray, lora))
    t = tlora.merge_lora(to_torch(layers, "cpu"), to_torch(lora, "cpu"))
    assert set(t) == set(j)
    for k in j:
        np.testing.assert_allclose(t[k].numpy(), np.asarray(j[k]), rtol=TOL, atol=TOL, err_msg=k)


def test_merge_vision_lora_matches_jax(tiny):
    jcfg, tcfg, backbone, _, vlora = tiny
    clip = backbone["vision"]["clip"]
    j = jlora.merge_vision_lora(clip, vlora)
    t = tlora.merge_vision_lora(to_torch(clip, "cpu"), to_torch(vlora, "cpu"))
    for path, jl_ in jax.tree_util.tree_flatten_with_path(j)[0]:
        node = t
        for key in path:
            node = node[key.key]
        np.testing.assert_allclose(node.numpy(), np.asarray(jl_), rtol=TOL, atol=TOL)


@pytest.mark.parametrize("which", ["decoder", "vision"])
def test_peft_dicts_both_ways_bit_for_bit(tiny, which):
    jcfg, tcfg, _, lora, vlora = tiny
    if which == "decoder":
        tree, cfg = lora, jcfg.decoder
        j_sd = jlora.stacked_to_peft_state(lora, cfg)
        t_sd = tlora.stacked_to_peft_state(to_torch(lora, "cpu"), tcfg.decoder)
        back_j = jlora.peft_state_to_stacked({k: v.numpy() for k, v in t_sd.items()}, cfg, 8, 4)
        back_t = tlora.peft_state_to_stacked(to_torch(j_sd, "cpu"), tcfg.decoder, 8, 4,
                                             device="cpu")
    else:
        tree, cfg = vlora, jcfg.vision
        j_sd = jlora.vision_stacked_to_peft_state(vlora, cfg)
        t_sd = tlora.vision_stacked_to_peft_state(to_torch(vlora, "cpu"), tcfg.vision)
        back_j = jlora.vision_peft_state_to_stacked({k: v.numpy() for k, v in t_sd.items()},
                                                    cfg, 8, 4)
        back_t = tlora.vision_peft_state_to_stacked(to_torch(j_sd, "cpu"), tcfg.vision, 8, 4,
                                                    device="cpu")
    assert set(t_sd) == set(j_sd)
    for k in j_sd:
        np.testing.assert_array_equal(t_sd[k].numpy(), j_sd[k], err_msg=k)
    for back in (back_j, to_numpy(back_t)):
        assert set(back) == set(tree)
        for name in tree:
            for leaf in ("a", "b", "scale"):
                np.testing.assert_array_equal(np.asarray(back[name][leaf]), tree[name][leaf])


def test_peft_reader_takes_default_segments_and_short_prefix(tiny):
    jcfg, tcfg, _, lora, _ = tiny
    sd = {k.replace("base_model.model.", "").replace(".weight", ".default.weight"): v
          for k, v in tlora.stacked_to_peft_state(to_torch(lora, "cpu"), tcfg.decoder).items()}
    back = tlora.peft_state_to_stacked(sd, tcfg.decoder, 8, 4, device="cpu")
    np.testing.assert_array_equal(back["qkv_proj"]["a"].numpy(), lora["qkv_proj"]["a"])
    with pytest.raises(KeyError, match="missing"):
        tlora.peft_state_to_stacked({}, tcfg.decoder, 8, 4, device="cpu")


def test_inline_lora_forward_matches_merged(tiny):
    """The decoder and the CLIP tower with inline LoRA against the same
    towers with the adapters merged into their weights."""
    jcfg, tcfg, backbone, lora, vlora = tiny
    bb = to_torch(backbone, "cpu")
    tl, tvl = to_torch(lora, "cpu"), to_torch(vlora, "cpu")
    rng = np.random.default_rng(3)
    B, S = 2, 24
    h = torch.from_numpy(rng.standard_normal((B, S, tcfg.decoder.hidden_size)).astype(np.float32))
    mask = torch.ones(B, S, dtype=torch.int32)
    mask[1, :5] = 0
    pos = torch.clamp(torch.cumsum(mask, -1) - 1, min=0)
    dec = bb["decoder"]
    inline = tphi3.forward(dec, tcfg.decoder, h, mask, pos, lora=tl).last_hidden_state
    merged_dec = {**dec, "layers": tlora.merge_lora(dec["layers"], tl)}
    merged = tphi3.forward(merged_dec, tcfg.decoder, h, mask, pos).last_hidden_state
    np.testing.assert_allclose(inline.numpy(), merged.numpy(), rtol=FWD_TOL, atol=FWD_TOL)

    pix = torch.from_numpy(rng.uniform(-1, 1, (2, 336, 336, 3)).astype(np.float32))
    clip = bb["vision"]["clip"]
    inline = tclip.extract_patch_features(clip, tcfg.vision, pix, lora=tvl)
    merged = tclip.extract_patch_features(tlora.merge_vision_lora(clip, tvl), tcfg.vision, pix)
    np.testing.assert_allclose(inline.numpy(), merged.numpy(), rtol=FWD_TOL, atol=FWD_TOL)


def test_initialisers_keep_the_jax_tree(tiny):
    jcfg, tcfg, _, lora, vlora = tiny
    gen = torch.Generator().manual_seed(0)
    t = tlora.init_lora(tcfg.decoder, 4, 8, gen, device="cpu")
    tv = tlora.init_vision_lora(tcfg.vision, 4, 8, gen, device="cpu")
    for ours, theirs, cfg in ((t, lora, tcfg.decoder), (tv, vlora, tcfg.vision)):
        assert set(ours) == set(theirs)
        for name, leaves in ours.items():
            for leaf in ("a", "b", "scale"):
                assert tuple(leaves[leaf].shape) == theirs[name][leaf].shape
                assert leaves[leaf].dtype == torch.float32
            bound = np.sqrt(6.0 / leaves["a"].shape[1])
            assert leaves["a"].abs().max().item() <= bound
            assert not leaves["b"].any() and bool((leaves["scale"] == 2.0).all())
    assert tlora.peft_adapter_config(4, 8, 0.05) == jlora.peft_adapter_config(4, 8, 0.05)


# ------------------------------------------------------------------ Qwen2.5-VL


@pytest.fixture(scope="module")
def qwen():
    jcfg, tcfg = qwen_tiny_config(num_layers=2), tconfig.qwen_tiny_config(num_layers=2)
    text = jax.tree_util.tree_map(
        np.asarray, jqwen.init_text_params(jax.random.PRNGKey(0), jcfg.text, jnp.float32))
    lora = _nonzero_b(jlora.init_lora(jax.random.PRNGKey(1), jcfg.text, 4, 8,
                                      targets=jlora.QWEN_TARGETS), 1)
    return jcfg, tcfg, text, lora


def test_qwen_targets_and_initialiser(qwen):
    jcfg, tcfg, _, lora = qwen
    assert tlora.QWEN_TARGETS == jlora.QWEN_TARGETS
    t = tlora.init_lora(tcfg.text, 4, 8, torch.Generator().manual_seed(0),
                        targets=tlora.QWEN_TARGETS, device="cpu")
    assert set(t) == set(lora) and list(t) == list(tlora.QWEN_TARGETS)
    for name, leaves in t.items():
        assert tlora._PEFT_PATH[name] == jlora._PEFT_PATH[name]
        assert tlora._target_dims(tcfg.text, name) == jlora._target_dims(jcfg.text, name)
        for leaf in ("a", "b", "scale"):
            assert tuple(leaves[leaf].shape) == lora[name][leaf].shape
        assert leaves["a"].abs().max().item() <= np.sqrt(6.0 / leaves["a"].shape[1])
        assert not leaves["b"].any() and bool((leaves["scale"] == 2.0).all())
    assert (tlora.peft_adapter_config(4, 8, 0.05, targets=tlora.QWEN_TARGETS)
            == jlora.peft_adapter_config(4, 8, 0.05, targets=jlora.QWEN_TARGETS))


def test_merge_lora_on_qwen_leaves_matches_jax(qwen):
    _, _, text, lora = qwen
    j = jlora.merge_lora(jax.tree_util.tree_map(jnp.asarray, text["layers"]),
                         jax.tree_util.tree_map(jnp.asarray, lora))
    t = tlora.merge_lora(to_torch(text["layers"], "cpu"), to_torch(lora, "cpu"))
    assert set(t) == set(j)
    for name in lora:
        assert set(t[name]) == set(j[name])  # kernel (+ bias), the bias untouched
        for leaf in j[name]:
            np.testing.assert_allclose(t[name][leaf].numpy(), np.asarray(j[name][leaf]),
                                       rtol=TOL, atol=TOL, err_msg=f"{name}/{leaf}")
    assert not np.array_equal(t["q_proj"]["kernel"].numpy(), text["layers"]["q_proj"]["kernel"])
    np.testing.assert_array_equal(t["input_layernorm"].numpy(), text["layers"]["input_layernorm"])


def test_qwen_peft_dicts_both_ways_bit_for_bit(qwen):
    jcfg, tcfg, _, lora = qwen
    j_sd = jlora.stacked_to_peft_state(lora, jcfg.text)
    t_sd = tlora.stacked_to_peft_state(to_torch(lora, "cpu"), tcfg.text)
    assert set(t_sd) == set(j_sd) and len(j_sd) == 2 * 7 * jcfg.text.num_layers
    for k in j_sd:
        np.testing.assert_array_equal(t_sd[k].numpy(), j_sd[k], err_msg=k)
    kw = dict(targets=jlora.QWEN_TARGETS)
    back_j = jlora.peft_state_to_stacked({k: v.numpy() for k, v in t_sd.items()}, jcfg.text, 8, 4,
                                         **kw)
    back_t = tlora.peft_state_to_stacked(to_torch(j_sd, "cpu"), tcfg.text, 8, 4, device="cpu",
                                         **kw)
    for back in (back_j, to_numpy(back_t)):
        assert set(back) == set(lora)
        for name in lora:
            for leaf in ("a", "b", "scale"):
                np.testing.assert_array_equal(np.asarray(back[name][leaf]), lora[name][leaf])


def test_qwen_inline_lora_matches_merged_and_fused(qwen):
    """The decoder with inline LoRA on the separate layout against the
    adapters merged and the projections fused (``merge_for_scoring``: what
    the scoring route reads back after training)."""
    from llava_reward_torch.evalx.adaptor import merge_for_scoring

    _, tcfg, text, lora = qwen
    tt, tl = to_torch(text, "cpu"), to_torch(lora, "cpu")
    rng = np.random.default_rng(4)
    B, S = 2, 20
    h = torch.from_numpy(rng.standard_normal((B, S, tcfg.text.hidden_size)).astype(np.float32))
    mask = torch.ones(B, S, dtype=torch.int32)
    mask[1, :6] = 0
    pos = torch.clamp(torch.cumsum(mask, -1) - 1, min=0)[None].expand(3, B, S)
    inline, _ = tqwen.text_forward(tt, tcfg.text, h, mask, pos, lora=tl)
    merged = merge_for_scoring({"text": tt, "visual": {}}, "qwen", lora=tl)["text"]
    assert "qkv_proj" in merged["layers"] and "q_proj" not in merged["layers"]
    assert "q_proj" in tt["layers"]  # the input tree is not modified
    out, _ = tqwen.text_forward(merged, tcfg.text, h, mask, pos)
    valid = mask.bool().numpy()
    np.testing.assert_allclose(out.numpy()[valid], inline.numpy()[valid], rtol=FWD_TOL,
                               atol=FWD_TOL)
