"""The port's Qwen2.5-VL backbone against the JAX package's, fp32 on the CPU:
the image geometry (bit-exact), the collator, the vision tower (f32 and u8
patches), the decoder on both layouts, and the W8A8 quantizer and
projection fusion on the qwen tree.

Two configs: ``qwen_tiny_config`` (head_dim 16 / 8: the kernel routes'
shape gates send everything to the reference) and a lane-aligned config
(text 256 wide, 2 heads / 1 kv head x 128, I = 512; vision 160 wide, 2 heads
x 80, depth 2 with one full block) whose attention reaches the kernel
entries: with ``attn_impl="pallas"`` JAX runs its Pallas kernels
interpreted and the port its plain versions (B2 x3 + B3 in the decoder,
B3's segment mode in the full block, its key-mask mode in the windows).
One param tree (JAX init, carried across by ``io/convert.py``) and one set
of numpy inputs feed both. fp32 tolerance 2e-5 on hidden states: two
summation orders through a few layers.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from llava_reward_tpu.core import config as jconfig
from llava_reward_tpu.models import qwen25_vl as jq
from llava_reward_tpu.preprocess import collate as jcollate
from llava_reward_tpu.preprocess import qwen_vision as jqv
from llava_reward_tpu.utils import quantize as jquant
from llava_reward_torch.core import config as tconfig
from llava_reward_torch.io.convert import to_numpy, to_torch
from llava_reward_torch.models import qwen25_vl as tq
from llava_reward_torch.ops import flash_attention as tfa
from llava_reward_torch.preprocess import collate as tcollate
from llava_reward_torch.preprocess import qwen_vision as tqv
from llava_reward_torch.utils import quantize as tquant

TOL = 2e-5


def lane_aligned_configs():
    """(JAX, port) configs whose attention reaches the kernel entries."""
    out = []
    for m in (jconfig, tconfig):
        out.append(m.Qwen25VLConfig(
            text=m.QwenTextConfig(
                vocab_size=512, hidden_size=256, intermediate_size=512, num_layers=2,
                num_heads=2, num_kv_heads=1, mrope_section=(16, 24, 24),
                pad_token_id=511, eos_token_id=511, image_token_id=510,
            ),
            vision=m.QwenVisionConfig(
                depth=2, hidden_size=160, intermediate_size=320, num_heads=2,
                out_hidden_size=256, fullatt_block_indexes=(1,),
            ),
            min_pixels=4 * 28 * 28, max_pixels=16 * 28 * 28,
        ))
    return tuple(out)


def tiny_configs(**kw):
    kw = {"vision_depth": 2, **kw}  # one window block, one full block
    return jconfig.qwen_tiny_config(**kw), tconfig.qwen_tiny_config(**kw)


def jax_tree(jcfg, seed=0):
    """The JAX package's qwen backbone as numpy (biases drawn nonzero, so
    that the bias paths are exercised)."""
    tree = jax.tree_util.tree_map(np.asarray, jq.init_params(jax.random.PRNGKey(seed), jcfg))
    rng = np.random.default_rng(seed + 100)

    def bias(t):
        if isinstance(t, dict):
            return {k: (rng.standard_normal(v.shape).astype(np.float32) * 0.02
                        if k == "bias" else bias(v)) for k, v in t.items()}
        return t

    return bias(tree)


def jtree(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def jit_call(fn, *args):
    """``fn(*args)`` under one ``jax.jit`` (one compile instead of JAX's
    op-by-op first call); ``fn`` closes over the static arguments."""
    return jax.jit(fn)(*args)


def image_sample(cfg, rng, grid, n_before=3, n_after=6, u8=False):
    """One processed sample through the port's ``sample_from_patches`` and
    the JAX package's processor geometry."""
    vc = cfg.vision
    n = grid[1] * grid[2]
    if u8:
        patches = rng.integers(0, 256, (n, vc.patch_dim)).astype(np.uint8)
    else:
        patches = rng.standard_normal((n, vc.patch_dim)).astype(np.float32)
    tid = cfg.text.image_token_id
    ids = np.concatenate([rng.integers(2, 400, n_before), [tid],
                          rng.integers(2, 400, n_after)]).astype(np.int32)
    return tqv.sample_from_patches(ids, patches, grid, tid, vc.window_size, vc.patch_size,
                                   vc.spatial_merge_size)


def _t(x):
    return None if x is None else torch.from_numpy(np.ascontiguousarray(x))


# ------------------------------------------------------------------ geometry


GEOMETRY = {
    "smart_resize": lambda m: [m.smart_resize(h, w, 28, lo, hi) for h, w, lo, hi in (
        (90, 120, 4 * 784, 16 * 784), (1000, 700, 256 * 784, 1280 * 784),
        (37, 2900, 4 * 784, 16384 * 784), (448, 560, 256 * 784, 1280 * 784))],
    "patch_norm_vectors": lambda m: m.patch_norm_vectors(3, 2, 14),
    "merged_block_pos": lambda m: [m._merged_block_pos(gh, gw, 2) for gh, gw in (
        (8, 12), (32, 40), (28, 36))],
    "windowize": lambda m: [m.windowize(g) for g in ((1, 8, 12), (1, 32, 40), (1, 28, 36),
                                                     (1, 10, 6))],
    "mrope_position_ids": lambda m: [
        m.mrope_position_ids(np.array([5, 9, 7, 7, 7, 7, 7, 7, 3, 4]), 7, (1, 4, 6)),
        m.mrope_position_ids(np.array([1, 2, 3]), 7, None),
        m.mrope_position_ids(np.array([7, 7, 7, 7, 1, 7, 7, 7, 7, 7, 7]), 7,
                             [(1, 4, 4), (1, 6, 4)]),
    ],
}


@pytest.mark.parametrize("name", sorted(GEOMETRY))
def test_geometry_is_bit_exact(name):
    def flat(x):
        if isinstance(x, (list, tuple)):
            return [y for e in x for y in flat(e)]
        return [np.asarray(x)]

    got, ref = flat(GEOMETRY[name](tqv)), flat(GEOMETRY[name](jqv))
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        assert g.dtype == r.dtype and np.array_equal(g, r)


@pytest.mark.parametrize("layout", ["f32", "u8"])
def test_sample_from_patches_matches_the_processor(layout):
    """The JAX processor on a PIL image against the port's sample_from_patches on
    the same patches: every field bit-exact."""
    from PIL import Image

    jcfg, _ = tiny_configs()
    rng = np.random.default_rng(5)
    img = Image.fromarray((rng.random((70, 100, 3)) * 255).astype(np.uint8))
    tid = jcfg.text.image_token_id

    class Tok:
        def __call__(self, text):
            return {"input_ids": [tid if t == "<img>" else 3 + len(t) for t in text.split()]}

    proc = jqv.Qwen25VLProcessor(Tok(), min_pixels=jcfg.min_pixels, max_pixels=jcfg.max_pixels,
                                 image_token_id=tid, device_preproc=layout == "u8")
    ref = proc("a pretty <img> photo of it", [img])
    patches, grid = jqv.image_to_patches(img, min_pixels=jcfg.min_pixels,
                                         max_pixels=jcfg.max_pixels, layout=layout)
    ids = np.asarray(Tok()("a pretty <img> photo of it")["input_ids"], np.int32)
    got = tqv.sample_from_patches(ids, patches, grid, tid)
    for f in dataclasses.fields(ref):
        a, b = getattr(got, f.name), getattr(ref, f.name)
        if isinstance(b, np.ndarray):
            assert a.dtype == b.dtype and np.array_equal(a, b), f.name
        else:
            assert a == b, f.name


@pytest.mark.parametrize("mix", ["f32", "u8", "mixed"])
def test_collate_matches_jax(mix):
    jcfg, tcfg = tiny_configs()
    rng = np.random.default_rng(6)
    samples = [
        image_sample(tcfg, rng, (1, 8, 12), u8=mix in ("u8", "mixed")),
        image_sample(tcfg, rng, (1, 4, 6), n_before=5, u8=mix == "u8"),
    ]
    kw = dict(seq_len=60, pad_token_id=tcfg.text.pad_token_id, patch_budget=256,
              unit_budget=32)
    got = tcollate.collate_qwen_samples(samples, **kw)
    ref = jcollate.collate_qwen_samples(samples, **kw)
    assert got["pixel_values"].dtype == (np.uint8 if mix == "u8" else np.float32)
    for k, r in ref.items():
        g = got[k]
        if r is None:
            assert g is None, k
        else:
            assert g.dtype == r.dtype and np.array_equal(g, r), k
    rb = tcollate.to_reward_batch(got, device="cpu")
    assert tuple(rb.position_ids.shape) == (3, 2, 60) and rb.patch_valid.dtype == torch.int32


# ------------------------------------------------------------------ vision


def _vision_inputs(cfg, grids, u8, seed):
    rng = np.random.default_rng(seed)
    samples = [image_sample(cfg, rng, g, u8=u8) for g in grids]
    b = tcollate.collate_qwen_samples(samples, 60, cfg.text.pad_token_id, 256, 32)
    return (b["pixel_values"], b["patch_valid"], b["rot_pos"], b["unit_gather"],
            b["num_img_tokens"])


VISION_CASES = {
    # name: (lane-aligned config?, u8 patches?, port attn_impl, JAX attn_impl)
    "tiny_f32": (False, False, "auto", "auto"),
    "tiny_u8": (False, True, "auto", "auto"),
    "lane_aligned_kernels": (True, False, "pallas", "pallas"),
    "lane_aligned_u8_kernels": (True, True, "pallas", "pallas"),
}


@pytest.mark.parametrize("case", sorted(VISION_CASES))
def test_vision_forward_matches_jax(case):
    aligned, u8, t_impl, j_impl = VISION_CASES[case]
    jcfg, tcfg = lane_aligned_configs() if aligned else tiny_configs()
    tree = jax_tree(jcfg)
    # (1, 8, 12) fills two windows exactly; (1, 4, 6) pads its one window
    fields = _vision_inputs(tcfg, [(1, 8, 12), (1, 4, 6)], u8, seed=7)
    ref = jit_call(lambda p, *f: jq.vision_forward(p, jcfg.vision, *f, attn_impl=j_impl),
                   jtree(tree["visual"]), *map(jnp.asarray, fields))
    tfa.reset_counters()
    got = tq.vision_forward(to_torch(tree["visual"], device="cpu"), tcfg.vision,
                            *map(_t, fields), attn_impl=t_impl)
    if aligned:  # the full block's segment mode and the window's key-mask mode
        assert tfa.PLAIN_CALLS["fa_hm"] == 2 and not any(tfa.LAUNCHES.values())
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=TOL, atol=TOL)
    assert np.all(got.numpy()[1, 6:] == 0)  # units past num_img_tokens are zero


def test_u8_patches_normalise_like_the_host():
    """u8 patches normalised on the device give the vision tokens of the same
    image normalised on the host (``collate_qwen_samples``' mixed-batch
    path), to f32 rounding."""
    _, tcfg = tiny_configs()
    tree = to_torch(jax_tree(tiny_configs()[0]), device="cpu")
    px, pv, rot, ug, n = _vision_inputs(tcfg, [(1, 8, 12), (1, 4, 6)], True, seed=8)
    host = np.stack([tcollate._host_norm(p, v) for p, v in zip(px, pv)])
    a = tq.vision_forward(tree["visual"], tcfg.vision, *map(_t, (px, pv, rot, ug, n)))
    b = tq.vision_forward(tree["visual"], tcfg.vision, *map(_t, (host, pv, rot, ug, n)))
    np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5, atol=2e-6)


# ------------------------------------------------------------------ decoder


def _decoder_inputs(cfg, B, S, pads, seed):
    rng = np.random.default_rng(seed)
    emb = rng.standard_normal((B, S, cfg.text.hidden_size)).astype(np.float32)
    mask = np.ones((B, S), np.int32)
    pos = np.ones((3, B, S), np.int32)
    for b, p in enumerate(pads):
        mask[b, :p] = 0
        ids = np.full(S - p, 3, np.int32)
        ids[4 : 4 + 12] = cfg.text.image_token_id
        pos[:, b, p:] = tqv.mrope_position_ids(ids, cfg.text.image_token_id, (1, 6, 8))
    return emb, mask, pos


DECODER_CASES = {
    # name: (lane-aligned config?, fused layout?, port attn_impl, JAX attn_impl)
    "tiny_separate": (False, False, "auto", "auto"),
    "tiny_fused": (False, True, "auto", "auto"),
    "lane_aligned_separate_kernels": (True, False, "pallas", "pallas"),
    "lane_aligned_fused_kernels": (True, True, "pallas", "pallas"),
}


@pytest.mark.parametrize("case", sorted(DECODER_CASES))
def test_decoder_matches_jax(case):
    aligned, fused, t_impl, j_impl = DECODER_CASES[case]
    jcfg, tcfg = lane_aligned_configs() if aligned else tiny_configs()
    layers = jax_tree(jcfg)["text"]
    if fused:
        layers = {**layers, "layers": jq.fuse_decoder_projections(layers["layers"])}
    emb, mask, pos = _decoder_inputs(tcfg, 2, 64, [0, 11], seed=9)
    jl, jc = jit_call(lambda p, *a: jq.text_forward(p, jcfg.text, *a, collect_layer_id=1,
                                                    attn_impl=j_impl),
                      jtree(layers), jnp.asarray(emb), jnp.asarray(mask), jnp.asarray(pos))
    tfa.reset_counters()
    tl, tc = tq.text_forward(to_torch(layers, device="cpu"), tcfg.text, _t(emb), _t(mask),
                             _t(pos), collect_layer_id=1, attn_impl=t_impl)
    if aligned:
        L = tcfg.text.num_layers
        want = {"prep": 3 * L, "fa_hm": L} if fused else {"fa_hm": L}
        assert {k: v for k, v in tfa.PLAIN_CALLS.items() if v} == want
    valid = mask.astype(bool)
    for got, ref in ((tl, jl), (tc, jc)):
        np.testing.assert_allclose(got.numpy()[valid], np.asarray(ref)[valid], rtol=TOL,
                                   atol=TOL)


def test_mrope_cos_sin_matches_jax():
    jcfg, tcfg = lane_aligned_configs()
    _, _, pos = _decoder_inputs(tcfg, 2, 64, [0, 11], seed=10)
    jc, js = jq._mrope_cos_sin(jnp.asarray(pos), jcfg.text, jnp.float32)
    tc, ts = tq._mrope_cos_sin(_t(pos), tcfg.text, torch.float32)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=0, atol=1e-6)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=0, atol=1e-6)


def test_w8a8_quantize_then_fuse_is_bit_exact():
    """quantize_stacked_layers and fuse_decoder_projections on the qwen tree
    (fused qkv with its bias, gate_up): the same codes, scales and layout as
    the JAX package's, and fusing after quantizing equals quantizing the
    fused tree."""
    jcfg, _ = lane_aligned_configs()
    layers = jax_tree(jcfg)["text"]["layers"]
    jfused = jq.fuse_decoder_projections(
        jquant.quantize_stacked_layers(layers, scheme="w8a8", min_size=0))
    tlayers = to_torch(layers, device="cpu")
    tfused = tq.fuse_decoder_projections(
        tquant.quantize_stacked_layers(tlayers, scheme="w8a8", min_size=0))
    jflat = jax.tree_util.tree_leaves_with_path(jax.tree_util.tree_map(np.asarray, jfused))
    tflat = jax.tree_util.tree_leaves_with_path(to_numpy(tfused))
    assert [p for p, _ in jflat] == [p for p, _ in tflat]
    for (path, a), (_, b) in zip(jflat, tflat):
        assert a.dtype == b.dtype and np.array_equal(a, b), path
    assert tquant.is_w8a8(tfused["qkv_proj"]["kernel"]) and "bias" in tfused["qkv_proj"]
    refused = tquant.quantize_stacked_layers(tq.fuse_decoder_projections(tlayers),
                                             scheme="w8a8", min_size=0)
    for name in ("qkv_proj", "gate_up_proj"):
        for k in ("qvalues_w8a8", "scale"):
            assert torch.equal(refused[name]["kernel"][k], tfused[name]["kernel"][k])


def test_init_params_tree_matches_jax_layout():
    jcfg, tcfg = tiny_configs()
    ref = jax.tree_util.tree_map(np.asarray, jq.init_params(jax.random.PRNGKey(0), jcfg))
    got = to_numpy(tq.init_params(tcfg, torch.Generator().manual_seed(0), device="cpu"))
    rs = jax.tree_util.tree_leaves_with_path(ref)
    gs = jax.tree_util.tree_leaves_with_path(got)
    assert [(p, a.shape, a.dtype) for p, a in rs] == [(p, a.shape, a.dtype) for p, a in gs]
