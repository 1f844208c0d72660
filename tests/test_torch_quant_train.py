"""LoRA training over a quantized frozen decoder (``--load_in_8bit`` /
``--load_in_4bit``), the port against the JAX package, fp32 on the CPU.

For phi3v (LoRA on DEFAULT_TARGETS, GPM + SkipCA), qwen and llava (LoRA on
QWEN_TARGETS and the projector) at their tiny configs, the decoder's stacked
layers quantized by the JAX ``quantize_stacked_layers`` (every leaf, min_size
0) as W8A8, NF4 and absmax int4, and the same tree carried across: the loss
and the preference probability against ``jax.value_and_grad``'s, and every
trainable leaf's gradient within a relative L2 error (||t - j|| / ||j||):

- NF4: dequantized to the same fp32 weights in both, so fp32 noise only:
  the loss within PARITY.md's 2.03e-05, the gradients within NF4_REL (the
  scale of GRAD_RTOL in tests/test_torch_qwen_train.py; read: <= 1.2e-05);
- W8A8 and absmax (int4 codes run as W8A8): the activations are quantized
  per row in the forward, and the two libraries' fp32 activations differ by
  an ulp (XLA's rsqrt and summation order), which now and then moves a
  value across a rounding boundary of its int8 code: amax/127 on one
  element, which the next layers carry. The loss is held to W8A8_LOSS_TOL,
  the bound of the W8A8 rewards in tests/test_torch_qwen_reward.py and
  tests/test_torch_quant_kernels.py (read: up to 4.8e-04), the gradients to
  W8A8_REL (read: up to 8.8e-03; a cut or wrong straight-through gradient
  reads ~1).

``_Int8LinearCore``'s backward against the JAX ``_int8_core_bwd``: bf16
operands with an fp32 result rounded once to dy's dtype, which on the CPU is
the fp32 product of the bf16 values cast to that dtype.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llava_reward_tpu.train import train_step as jts
from llava_reward_tpu.utils import quantize as jquant
from llava_reward_torch.io.convert import to_torch
from llava_reward_torch.train import optim as toptim
from llava_reward_torch.train import train_step as tts
from llava_reward_torch.utils import quantize as tquant

import test_torch_llava as llava_t
import test_torch_qwen_train as qwen_t
import test_torch_train_step as phi3v_t

LOSS_TOL = 2.03e-05
W8A8_LOSS_TOL = 2e-3
NF4_REL = 1e-4
W8A8_REL = 2e-2
SCHEMES = {"w8a8": dict(scheme="w8a8"), "nf4": dict(bits=4, scheme="nf4"),
           "absmax": dict(bits=4, scheme="absmax")}


def _family(name):
    """(jcfg, tcfg, jr, tr, frozen, trainable, chosen, rejected, jb, tb, kw, dec)"""
    if name == "phi3v":
        jcfg, tcfg, jr, tr, frozen, trainable = phi3v_t._setup(
            dict(is_general_preference=True, value_head_dim=2, add_cross_attention=True))
        chosen, rejected = phi3v_t._pair(tcfg)
        return (jcfg, tcfg, jr, tr, frozen, trainable, chosen, rejected, phi3v_t._jb,
                phi3v_t._tb, {}, "decoder")
    if name == "qwen":
        jcfg, tcfg, jr, tr, frozen, trainable = qwen_t._setup("lora")
        chosen, rejected = qwen_t._pair(tcfg)
        return (jcfg, tcfg, jr, tr, frozen, trainable, chosen, rejected, qwen_t._jb, qwen_t._tb,
                dict(projector_path=qwen_t.QWEN_PATH), "text")
    jcfg, tcfg, jr, tr, frozen, trainable = llava_t._setup_lora()
    chosen, rejected = llava_t._pair_fields(tcfg, [(50, 900), (120, 700)], seed=1)
    return (jcfg, tcfg, jr, tr, frozen, trainable, chosen, rejected, llava_t._jb, llava_t._tb,
            dict(projector_path=llava_t.LLAVA_PATH), "text")


def _quantized(frozen, dec, scheme):
    bb = frozen["backbone"]
    layers = jquant.quantize_stacked_layers(bb[dec]["layers"], min_size=0, **SCHEMES[scheme])
    layers = jax.tree_util.tree_map(np.asarray, layers)
    return {"backbone": {**bb, dec: {**bb[dec], "layers": layers}}}


def _qleaves(tree):
    return [k for k, v in tree.items() if isinstance(v, dict) and (
        tquant.is_quantized(v) or tquant.is_w8a8(v) or _qleaves(v))]


@pytest.mark.parametrize("scheme", list(SCHEMES))
@pytest.mark.parametrize("family", ["phi3v", "qwen", "llava"])
def test_lora_grads_over_a_quantized_decoder_match_jax(family, scheme):
    jcfg, tcfg, jr, tr, frozen, trainable, chosen, rejected, jb, tb, kw, dec = _family(family)
    frozen = _quantized(frozen, dec, scheme)
    assert _qleaves(frozen["backbone"][dec]["layers"])  # every projection quantized
    kw = dict(attn_impl="auto", remat=True, **kw)
    jfn = jts.make_pairwise_loss_fn(jcfg, jr, **kw)
    tfn = tts.make_pairwise_loss_fn(tcfg, tr, **kw)
    jt = lambda tree: jax.tree_util.tree_map(jnp.asarray, tree)  # noqa: E731
    (jloss, jm), jgrads = jax.jit(jax.value_and_grad(jfn, has_aux=True))(
        jt(trainable), jt(frozen), jb(chosen), jb(rejected))
    tt = qwen_t._ttrainable(trainable)
    tfrozen = to_torch(frozen, "cpu")
    if scheme == "w8a8":  # the codes cross K-major, as every W8A8 leaf is laid out
        codes = [c for _, c in _w8a8_codes(tfrozen)]
        assert codes and all(c.mT.is_contiguous() for c in codes)
    tloss, tm = tfn(tt, tfrozen, tb(chosen), tb(rejected))
    leaves = toptim.tree_leaves(tt)
    grads = torch.autograd.grad(tloss, leaves, allow_unused=True)
    tol = LOSS_TOL if scheme == "nf4" else W8A8_LOSS_TOL
    np.testing.assert_allclose(tloss.item(), float(jloss), rtol=0, atol=tol)
    np.testing.assert_allclose(tm["prob"].item(), float(jm["prob"]), rtol=0, atol=tol)
    it = iter(grads)
    tgrads = toptim.tree_map(lambda p: next(it), tt)
    bound = NF4_REL if scheme == "nf4" else W8A8_REL
    n = 0
    for path, j in qwen_t._paths(qwen_t._np(jgrads)):
        t = qwen_t._get(tgrads, path).detach().numpy()
        rel = np.linalg.norm(t - j) / max(np.linalg.norm(j), 1e-30)
        assert rel <= bound, f"{'/'.join(path)}: relative L2 error {rel:.3e} > {bound:g}"
        n += 1
    assert n == len(leaves)
    for name, t in tgrads["lora"].items():  # the straight-through backward reaches every layer
        assert all(float(t["a"][i].abs().max()) > 0 for i in range(t["a"].shape[0])), name


def _w8a8_codes(tree, path=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            if k == tquant.W8A8_KEY:
                yield path, v
            else:
                yield from _w8a8_codes(v, f"{path}/{k}")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_int8_core_backward_matches_jax(dtype):
    """dx = (dy * scale) @ w^T through ``_Int8LinearCore`` against JAX's custom
    VJP rule on the same codes (the weights get no gradient; within a few
    fp32 ulps of the largest, XLA's summation order), and equal to the fp32
    product of the bf16 operands rounded once to dy's dtype."""
    rng = np.random.default_rng(0)
    M, K, N = 24, 96, 80
    w = rng.standard_normal((K, N)).astype(np.float32)
    qd = jax.tree_util.tree_map(np.asarray, jquant.quantize_array_w8a8(jnp.asarray(w)))
    x = rng.standard_normal((M, K)).astype(np.float32)
    dy = rng.standard_normal((M, N)).astype(np.float32)
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    jdx, jdw, jds = jquant._int8_core_bwd((jnp.asarray(qd[jquant._Q8A]), jnp.asarray(qd["scale"])),
                                         jnp.asarray(dy).astype(jdt))
    tq = to_torch(qd, "cpu")
    xt = torch.from_numpy(x).to(dtype).requires_grad_()
    y = tquant.int8_linear(xt, tq)
    (tdx,) = torch.autograd.grad(y, [xt], torch.from_numpy(dy).to(dtype))
    assert tdx.dtype == dtype
    jdx = np.asarray(jdx.astype(jnp.float32))
    # the same bf16 operands; XLA sums the fp32 products in its own order
    np.testing.assert_allclose(tdx.float().numpy(), jdx, rtol=0,
                               atol=2.0 ** -20 * np.abs(jdx).max())
    dys = (torch.from_numpy(dy).to(dtype).float() * tq["scale"]).to(torch.bfloat16)
    want = (dys.float() @ tq[tquant.W8A8_KEY].float().t()).to(dtype)
    assert torch.equal(tdx, want)
    assert not np.asarray(jds).any()  # nor the scale
