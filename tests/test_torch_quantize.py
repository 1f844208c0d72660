"""The port's ``utils/quantize.py`` against the JAX package's, on the CPU.

- quantizers (W8A8, int8 / int4 absmax, NF4) and ``quantize_stacked_layers``
  give the same codes and scales bit for bit, and ``dequant_layer`` the same
  dense weights (packed int4 -> the same W8A8 codes);
- ``int8_linear`` and ``int8_linear_pre`` equal JAX bit for bit in f32 and
  bf16 (integer sums are exact and the epilogue runs in the same order);
- the straight-through backward of ``int8_linear`` matches ``jax.grad``
  within 1e-5 relative (fp32 sums in another order);
- quantized trees cross ``io.convert`` in both directions bit for bit;
- a W8A8 leaf in the CLIP tower raises (ROADMAP B9).
Weights and inputs come from a numpy seed."""

import ml_dtypes
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from llava_reward_tpu.core.config import phi3v_tiny_config
from llava_reward_tpu.models import phi3 as jphi3
from llava_reward_tpu.utils import quantize as jq
from llava_reward_torch.core import config as tconfig
from llava_reward_torch.io.convert import to_numpy, to_torch
from llava_reward_torch.models import clip_vit as tclip
from llava_reward_torch.utils import quantize as tq

SCHEMES = {  # name: (scheme, bits)
    "w8a8": ("w8a8", 8),
    "int8": ("absmax", 8),
    "int4": ("absmax", 4),
    "nf4": ("nf4", 8),
}


def _weights(seed, *shape, zero_col=True):
    w = np.random.default_rng(seed).standard_normal(shape).astype(np.float32) * 0.05
    if zero_col:
        w[..., 3] = 0.0  # absmax 0: the scale falls back to 1
    return w


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = v
    return out


def _assert_trees_equal(t_tree, j_tree):
    t, j = _flat(to_numpy(t_tree)), _flat(jax.tree_util.tree_map(np.asarray, j_tree))
    assert t.keys() == j.keys()
    for k, a in j.items():
        b = t[k]
        assert b.dtype == a.dtype and b.shape == a.shape, (k, b.dtype, a.dtype)
        assert np.array_equal(a.view(np.uint8), b.view(np.uint8)), k


def _decoder_layers(dtype=jnp.float32):
    cfg = phi3v_tiny_config(hidden_size=128, intermediate_size=256).decoder
    tree = jphi3.init_params(jax.random.PRNGKey(0), cfg, dtype)["layers"]
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.mark.parametrize("dtype", [np.float32, ml_dtypes.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("name", sorted(SCHEMES))
def test_quantizers_match_jax_bit_for_bit(name, dtype):
    scheme, bits = SCHEMES[name]
    w = _weights(0, 2, 128, 96).astype(dtype)
    jfn = {"w8a8": jq.quantize_array_w8a8, "nf4": jq.quantize_array_nf4,
           "absmax": lambda a: jq.quantize_array(a, bits)}[scheme]
    tfn = {"w8a8": tq.quantize_array_w8a8, "nf4": tq.quantize_array_nf4,
           "absmax": lambda a: tq.quantize_array(a, bits)}[scheme]
    _assert_trees_equal(tfn(to_torch({"w": w}, device="cpu")["w"]), jfn(w))


@pytest.mark.parametrize("name", sorted(SCHEMES))
def test_stacked_layers_and_dequant_layer_match_jax(name):
    scheme, bits = SCHEMES[name]
    layers = _decoder_layers()
    kw = dict(bits=bits, scheme=scheme, min_size=0, only=("qkv_proj", "gate_up_proj", "down_proj"))
    jl = jq.quantize_stacked_layers(layers, **kw)
    tl = tq.quantize_stacked_layers(to_torch(layers, device="cpu"), **kw)
    _assert_trees_equal(tl, jl)
    assert not isinstance(tl["o_proj"], dict)  # outside ``only``: untouched
    for i in range(2):
        jd =jq.dequant_layer(jax.tree_util.tree_map(lambda x: jnp.asarray(x[i]), jl),
                              jnp.float32)
        td = tq.dequant_layer(tclip.layer_slice(tl, i), torch.float32)
        _assert_trees_equal(td, jd)
        if name == "int4":  # packed int4 runs as W8A8 codes
            assert tq.is_w8a8(td["qkv_proj"]) and jq.is_w8a8(jd["qkv_proj"])


def test_min_size_keeps_small_leaves_dense():
    tl = tq.quantize_stacked_layers(to_torch(_decoder_layers(), device="cpu"), scheme="w8a8")
    assert all(not isinstance(v, dict) for v in tl.values())  # all under 1 << 20


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("M", [120, 200])
def test_int8_linear_and_pre_match_jax_bit_for_bit(dtype, M):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((M, 256)).astype(np.float32)
    x[7] = 0.0  # a zero row: amax := 1
    xj = jnp.asarray(x).astype(dtype)
    xt = to_torch({"x": np.asarray(xj)}, device="cpu")["x"]
    qd = jq.quantize_array_w8a8(_weights(2, 256, 384))
    qt = to_torch(qd, device="cpu")
    qj = jax.tree_util.tree_map(jnp.asarray, qd)
    y_t = tq.int8_linear(xt.reshape(2, M // 2, 256), qt)
    y_j = jq.int8_linear(xj.reshape(2, M // 2, 256), qj)
    _assert_trees_equal({"y": y_t}, {"y": y_j})

    codes = rng.integers(-127, 128, (M, 256)).astype(np.int8)
    rs = rng.uniform(0.1, 4.0, (M, 1)).astype(np.float32)
    p_t = tq.int8_linear_pre(torch.from_numpy(codes), torch.from_numpy(rs), qt,
                             torch.float32 if dtype == jnp.float32 else torch.bfloat16)
    p_j = jq.int8_linear_pre(jnp.asarray(codes), jnp.asarray(rs), qj, dtype)
    _assert_trees_equal({"y": p_t}, {"y": p_j})


def test_int8_linear_backward_matches_jax_grad():
    rng = np.random.default_rng(3)
    x = rng.standard_normal((4, 10, 128)).astype(np.float32)
    g = rng.standard_normal((4, 10, 256)).astype(np.float32)
    qd = jq.quantize_array_w8a8(_weights(4, 128, 256))
    qj = jax.tree_util.tree_map(jnp.asarray, qd)
    dx_j = jax.grad(lambda a: jnp.sum(jq.int8_linear(a, qj) * jnp.asarray(g)))(jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_(True)
    qt = to_torch(qd, device="cpu")
    torch.sum(tq.int8_linear(xt, qt) * torch.from_numpy(g)).backward()
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(dx_j), rtol=1e-5, atol=1e-6)
    assert not qt["qvalues_w8a8"].requires_grad


@pytest.mark.parametrize("name", sorted(SCHEMES))
def test_quantized_trees_cross_convert_both_ways(name):
    scheme, bits = SCHEMES[name]
    jl = jq.quantize_stacked_layers(_decoder_layers(), bits=bits, scheme=scheme, min_size=0)
    # numpy -> tensors -> numpy
    _assert_trees_equal(to_torch(jl, device="cpu"), jl)
    # the port's own tree: tensors -> numpy -> tensors
    tl = tq.quantize_stacked_layers(to_torch(_decoder_layers(), device="cpu"), bits=bits,
                                    scheme=scheme, min_size=0)
    back = to_torch(to_numpy(tl), device="cpu")
    ft, fb = _flat(tl), _flat(back)
    assert ft.keys() == fb.keys()
    for k in ft:
        assert ft[k].dtype == fb[k].dtype and torch.equal(ft[k], fb[k]), k


def test_w8a8_clip_weights_raise():
    cfg = tconfig.phi3v_tiny_config()
    params = tclip.init_params(cfg.vision, torch.Generator().manual_seed(0), device="cpu")
    fc1 = params["layers"]["mlp"]["fc1"]
    fc1["kernel"] = tq.quantize_array_w8a8(fc1["kernel"])
    pix = torch.zeros(1, 336, 336, 3)
    with pytest.raises(NotImplementedError, match="B9"):
        tclip.extract_patch_features(params, cfg.vision, pix)
