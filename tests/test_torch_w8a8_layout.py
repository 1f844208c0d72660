"""The K-major layout of the port's W8A8 leaves, on the CPU.

The card's int8 GEMM reads its weight K-major (wgmma takes s8 operands
K-major only, and TMA cannot transpose bytes), so every W8A8 leaf keeps the
JAX package's ``(in, out)`` shape and values with strides ``(1, in)`` per
layer (``utils/quantize.k_major``). For each place that makes such a leaf
(the quantizers, the stacked-layer quantizer, the Qwen2.5-VL projection
fusion, the CLIP tower's per-call q/k/v concatenation, the packed-int4 unpack
in ``dequant_layer``, ``io.convert.to_torch``), the leaf's layout is checked
and its codes and scales are held equal to the JAX quantizer's on the same
numpy weights. Then the tiny W8A8 Phi-3.5-vision (tower and decoder) and
Qwen2.5-VL rewards on the plain route: every weight the GEMM's plain version
receives is K-major, and the rewards equal, bit for bit, those of the same
tree with its codes made contiguous (N-major).
"""

import numpy as np
import pytest
import torch

from llava_reward_tpu.models import qwen25_vl as jqwen
from llava_reward_tpu.utils import quantize as jq
from llava_reward_torch.evalx.adaptor import RewardAdaptor
from llava_reward_torch.io.convert import to_numpy, to_torch
from llava_reward_torch.models import clip_vit as tclip
from llava_reward_torch.models import qwen25_vl as tqwen
from llava_reward_torch.ops import int8_matmul as tim
from llava_reward_torch.reward.model import RewardBatch as TBatch
from llava_reward_torch.utils import quantize as tq
from test_torch_quant_kernels import N_IMG, TOWER_KW, _w8a8_tree
from test_torch_quant_kernels import _batch as phi3v_batch
from test_torch_qwen_reward import _batch as qwen_batch
from test_torch_qwen_reward import _setup as qwen_setup
from test_torch_qwen_reward import _tb as qwen_tb

W8A8 = "qvalues_w8a8"


def _weights(*shape, seed=0):
    w = np.random.default_rng(seed).standard_normal(shape).astype(np.float32) * 0.05
    w[..., 3] = 0.0  # a zero output column: scale := 1
    return w


def _assert_k_major(codes):
    """(..., in, out) int8 with strides (1, in) on the last two axes."""
    assert codes.dtype == torch.int8
    assert codes.stride()[-2:] == (1, codes.shape[-2]), codes.stride()
    assert codes.mT.is_contiguous()


def _assert_equal_jax(t, j):
    assert tuple(t[W8A8].shape) == j[W8A8].shape
    np.testing.assert_array_equal(t[W8A8].numpy(), np.asarray(j[W8A8]))
    np.testing.assert_array_equal(t["scale"].numpy(), np.asarray(j["scale"]))


def _w8a8_leaves(tree):
    if isinstance(tree, dict):
        if W8A8 in tree:
            yield tree
        else:
            for v in tree.values():
                yield from _w8a8_leaves(v)


@pytest.mark.parametrize("shape", [(256, 96), (3, 128, 80)], ids=["2d", "stacked"])
def test_quantize_array_w8a8_is_k_major(shape):
    w = _weights(*shape)
    t = tq.quantize_array_w8a8(torch.from_numpy(w))
    _assert_k_major(t[W8A8])
    _assert_equal_jax(t, jq.quantize_array_w8a8(w))


def test_quantize_stacked_layers_lays_each_layer_out_k_major():
    layers = {"qkv_proj": _weights(3, 128, 384, seed=1), "o_proj": _weights(3, 128, 128, seed=2),
              "norm": _weights(3, 128, seed=3)}
    jl = jq.quantize_stacked_layers(layers, scheme="w8a8", min_size=0)
    tl = tq.quantize_stacked_layers(to_torch(layers, device="cpu"), scheme="w8a8", min_size=0)
    for name in ("qkv_proj", "o_proj"):
        _assert_k_major(tl[name][W8A8])
        for i in range(3):  # a layer slice, as the decoder loop takes it
            _assert_k_major(tl[name][W8A8][i])
        _assert_equal_jax(tl[name], jl[name])
    assert torch.equal(tl["norm"], torch.from_numpy(layers["norm"]))


def test_fused_qwen_projections_stay_k_major():
    names = ("q_proj", "k_proj", "v_proj", "gate_proj", "up_proj")
    layers = {n: {"kernel": _weights(2, 128, 64 if n in ("k_proj", "v_proj") else 128, seed=i),
                  "bias": _weights(2, 64 if n in ("k_proj", "v_proj") else 128, seed=10 + i)}
              for i, n in enumerate(names)}
    jl = jqwen.fuse_decoder_projections(
        jq.quantize_stacked_layers(layers, scheme="w8a8", min_size=0))
    tl = tqwen.fuse_decoder_projections(
        tq.quantize_stacked_layers(to_torch(layers, device="cpu"), scheme="w8a8", min_size=0))
    for name in ("qkv_proj", "gate_up_proj"):
        _assert_k_major(tl[name]["kernel"][W8A8])
        _assert_equal_jax(tl[name]["kernel"], jl[name]["kernel"])
        np.testing.assert_array_equal(tl[name]["bias"].numpy(), np.asarray(jl[name]["bias"]))


def test_clip_tower_concatenates_q_k_v_k_major(monkeypatch):
    """The W8A8 tower's fused q/k/v projection, concatenated per layer and
    call, reaches the GEMM K-major, with the JAX package's codes."""
    cfg = _w8a8_tree(TOWER_KW, tower=True)
    tcfg, ttree, tree = cfg[1], cfg[5], cfg[4]
    seen = []
    real = tclip.cat_out

    def spy(parts):
        out = real(parts)
        seen.append(out)
        return out

    monkeypatch.setattr(tclip, "cat_out", spy)
    clip = ttree["backbone"]["vision"]["clip"]
    H = tcfg.vision.hidden_size
    h = torch.from_numpy(np.random.default_rng(4).standard_normal((2, 40, H)).astype(np.float32))
    tclip._encoder_layer(h, tclip.layer_slice(clip["layers"], 1), tcfg.vision, "fused_plain",
                         quant_route=True)
    assert len(seen) == 1
    _assert_k_major(seen[0][W8A8])
    jl = tree["backbone"]["vision"]["clip"]["layers"]["attn"]
    want = np.concatenate([jl[n]["kernel"][W8A8][1] for n in ("q", "k", "v")], axis=-1)
    np.testing.assert_array_equal(seen[0][W8A8].numpy(), want)


def test_int4_unpacks_to_k_major_w8a8():
    w = _weights(2, 128, 96, seed=5)
    packed = tq.quantize_stacked_layers({"w": torch.from_numpy(w)}, bits=4, min_size=0)["w"]
    jpacked = jq.quantize_stacked_layers({"w": w}, bits=4, min_size=0)["w"]
    for i in range(2):
        t = tq.dequant_layer({"w": {k: v[i] for k, v in packed.items()}})["w"]
        j = jq.dequant_layer({"w": {k: np.asarray(v)[i] for k, v in jpacked.items()}})["w"]
        _assert_k_major(t[W8A8])
        _assert_equal_jax(t, j)


def test_to_torch_lays_w8a8_codes_out_k_major_and_to_numpy_restores_them():
    tree = {"layers": jq.quantize_stacked_layers({"o_proj": _weights(2, 64, 48)},
                                                 scheme="w8a8", min_size=0)}
    t = to_torch(tree, device="cpu")
    _assert_k_major(t["layers"]["o_proj"][W8A8])
    back = to_numpy(t)["layers"]["o_proj"]
    assert back[W8A8].flags.c_contiguous
    np.testing.assert_array_equal(back[W8A8], np.asarray(tree["layers"]["o_proj"][W8A8]))
    np.testing.assert_array_equal(back["scale"], np.asarray(tree["layers"]["o_proj"]["scale"]))


def _contiguous_codes(tree):
    """The same tree with every W8A8 leaf's codes made contiguous (N-major)."""
    if isinstance(tree, dict):
        return {k: (v.contiguous() if k == W8A8 else _contiguous_codes(v))
                for k, v in tree.items()}
    return tree


def _spy_gemm(monkeypatch):
    """Record the weight layout that reaches the GEMM's plain version by
    either name the routes call it by."""
    seen = []
    real = tim.int8_matmul_pre_plain

    def spy(codes, amax, wq, wscale, out_dtype):
        seen.append(wq.stride() == (1, wq.shape[0]))
        return real(codes, amax, wq, wscale, out_dtype)

    monkeypatch.setattr(tim, "int8_matmul_pre_plain", spy)
    monkeypatch.setattr(tq, "int8_matmul_pre_plain", spy)
    return seen


def _scores(model_type, tcfg, tr, ttree, batch):
    kw = {"model_type": model_type} if model_type == "qwen" else {}
    adaptor = RewardAdaptor(tcfg, tr, ttree, device="cpu", **kw)
    return adaptor.make_score_fn(attn_impl="plain")(ttree, batch)


@pytest.mark.parametrize("model", ["phi3v", "qwen"])
def test_w8a8_rewards_on_k_major_trees_equal_contiguous_trees(model, monkeypatch):
    """The tiny W8A8 rewards on the plain route (Phi-3.5-vision with the CLIP
    tower W8A8 too; Qwen2.5-VL quantized, then fused): K-major codes reach the
    GEMM, and the rewards are those of the N-major tree, bit for bit."""
    if model == "phi3v":
        _, tcfg, _, tr, tree, ttree = _w8a8_tree(TOWER_KW, tower=True)
        fields = phi3v_batch(tcfg, [0, 30, 12, 0], [N_IMG, N_IMG - 40, N_IMG - 7, N_IMG], seed=7)
        batch = TBatch(*map(torch.from_numpy, fields))
    else:
        _, tcfg, _, tr, tree, ttree = qwen_setup(True, w8a8=True)
        batch = qwen_tb(qwen_batch(tcfg, [0, 9, 3, 0], seed=6))
    leaves = list(_w8a8_leaves(ttree))
    assert leaves
    for leaf in leaves:
        _assert_k_major(leaf[W8A8])
    seen = _spy_gemm(monkeypatch)
    got = _scores(model, tcfg, tr, ttree, batch)
    assert seen and all(seen)
    n_major = _contiguous_codes(ttree)
    assert not any(leaf[W8A8].mT.is_contiguous() for leaf in _w8a8_leaves(n_major))
    ref = _scores(model, tcfg, tr, n_major, batch)
    assert got.shape == (4, 2) and bool(torch.isfinite(got).all())
    assert torch.equal(got, ref)
