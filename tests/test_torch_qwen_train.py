"""Qwen2.5-VL training in the port against the JAX package's, fp32 on the CPU.

One (chosen, rejected) pair at ``qwen_tiny_config(num_layers=2,
vision_depth=2)``: the rejected side is left-padded and its image leaves pad
slots among the patches. One param tree (JAX init, carried across by
``io/convert.py``) and one set of numpy inputs feed both packages. LoRA ``b``
is made nonzero (with b = 0 the gradient of ``a`` is exactly zero).

- (a) heads + LoRA on ``QWEN_TARGETS`` + the merger as ``--ft_projector``'s
  trainable projector: loss and every trainable leaf's gradient against
  ``jax.value_and_grad`` of the JAX loss function;
- (b) full fine-tuning (``trainable['backbone']`` holds the whole backbone, no
  LoRA): the same, vision tower leaves included;
- one ``make_train_step`` step (the second: the first has lr 0) leaves the same
  trainable tree as JAX's;
- at the lane-aligned config (vision head_dim 80, text head_dim 128) with
  ``attn_impl="pallas"``: JAX runs its Pallas kernels interpreted, forward and
  ``_fa_bwd_kernel`` in the left-pad (decoder), segment (full vision block) and
  key-mask (window block) modes; the port goes through ``_FlashAttentionCore``
  with the plain B3 / B8. Full fine-tuning, so the vision blocks' backward
  runs. The same gradients must also come out of the port's reference route;
- a trainable vision tower gets the same gradients from u8 patches (normalised
  on the device) as from the host-normalised f32 patches;
- fp32 heads and merger over a bf16 backbone (the card's layout) train:
  the merger's products promote as ``jnp`` does.

Tolerances: loss LOSS_TOL; gradients |t - j| <= GRAD_RTOL * max|j| per leaf
(fp32 through ~30 ops per layer in two libraries); after AdamW steps STEP_TOL.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llava_reward_tpu.core.config import RewardConfig as JRewardConfig
from llava_reward_tpu.lora import lora as jlora
from llava_reward_tpu.preprocess import collate as jcollate
from llava_reward_tpu.reward.model import init_head_params as j_init_head
from llava_reward_tpu.train import optim as joptim
from llava_reward_tpu.train import train_step as jts
from llava_reward_torch.core import config as tconfig
from llava_reward_torch.io.convert import to_numpy, to_torch
from llava_reward_torch.lora import lora as tlora
from llava_reward_torch.ops import flash_attention as tfa
from llava_reward_torch.preprocess import collate as tcollate
from llava_reward_torch.train import optim as toptim
from llava_reward_torch.train import train_step as tts
from test_torch_qwen_model import image_sample, jax_tree, lane_aligned_configs, tiny_configs

LOSS_TOL = 2e-5
GRAD_RTOL = 1e-4
STEP_TOL = 2e-5
GPM = dict(is_general_preference=True, value_head_dim=2, add_cross_attention=True)
QWEN_PATH = tts.PROJECTOR_PATHS["qwen"]


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _jtree(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def _setup(mode, aligned=False):
    """mode 'lora': heads + LoRA + merger trainable over a frozen backbone;
    'full': heads + the whole backbone trainable."""
    jcfg, tcfg = lane_aligned_configs() if aligned else tiny_configs(num_layers=2)
    kw = dict(GPM, layer_id=jcfg.text.num_layers)
    jr, tr = JRewardConfig(**kw), tconfig.RewardConfig(**kw)
    backbone = jax_tree(jcfg)
    trainable = {"head": _np(j_init_head(jax.random.PRNGKey(1), jcfg, jr))}
    if mode == "lora":
        lora = _np(jlora.init_lora(jax.random.PRNGKey(2), jcfg.text, 4, 8,
                                   targets=jlora.QWEN_TARGETS))
        rng = np.random.default_rng(3)
        for t in lora.values():
            t["b"] = rng.standard_normal(t["b"].shape).astype(np.float32) * 0.05
        trainable.update(lora=lora, projector=backbone["visual"]["merger"])
        frozen = {"backbone": backbone}
    else:
        trainable["backbone"] = backbone
        frozen = {}
    return jcfg, tcfg, jr, tr, frozen, trainable


def _fields(cfg, grid, pad, seed, u8=False, seq_len=72):
    rng = np.random.default_rng(seed)
    n_units = (grid[1] // 2) * (grid[2] // 2)
    sample = image_sample(cfg, rng, grid, n_before=2, n_after=seq_len - 3 - n_units - pad, u8=u8)
    return tcollate.collate_qwen_samples([sample], seq_len, cfg.text.pad_token_id,
                                         patch_budget=128, unit_budget=24)


def _pair(cfg, u8=False):
    """chosen: 8 x 12 patches, no left pad; rejected: 6 x 12 (partial windows:
    pad slots among the patches), left-padded by 9."""
    return _fields(cfg, (1, 8, 12), 0, 1, u8), _fields(cfg, (1, 6, 12), 9, 2, u8)


def _jb(fields):
    return jcollate.to_reward_batch({k: None if v is None else jnp.asarray(v)
                                     for k, v in fields.items()})


def _tb(fields):
    return tcollate.to_reward_batch(fields, device="cpu")


def _ttrainable(tree):
    t = to_torch(tree, "cpu")
    for leaf in toptim.tree_leaves(t):
        leaf.requires_grad_(True)
    return t


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


def _torch_grads(loss_fn, trainable, frozen, *args):
    loss, metrics = loss_fn(trainable, frozen, *args)
    leaves = toptim.tree_leaves(trainable)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    it = iter(grads)
    return loss, metrics, toptim.tree_map(lambda p: next(it), trainable)


def _assert_grads(tgrads, jgrads, rtol=GRAD_RTOL):
    n = 0
    for path, j in _paths(_np(jgrads)):
        t = _get(tgrads, path)
        assert t is not None, path
        bound = rtol * max(np.abs(j).max(), 1e-12)
        err = np.abs(t.detach().numpy() - j).max()
        assert err <= bound, f"{'/'.join(path)}: max err {err:.3e} > {bound:.3e}"
        n += 1
    return n


def _compare(mode, *, aligned=False, attn_impl="auto"):
    jcfg, tcfg, jr, tr, frozen, trainable = _setup(mode, aligned)
    chosen, rejected = _pair(tcfg)
    kw = dict(attn_impl=attn_impl, remat=True, projector_path=QWEN_PATH)
    jfn = jts.make_pairwise_loss_fn(jcfg, jr, **kw)
    tfn = tts.make_pairwise_loss_fn(tcfg, tr, **kw)
    (jloss, jmetrics), jgrads = jax.jit(jax.value_and_grad(jfn, has_aux=True))(
        _jtree(trainable), _jtree(frozen), _jb(chosen), _jb(rejected))
    tloss, tmetrics, tgrads = _torch_grads(tfn, _ttrainable(trainable), to_torch(frozen, "cpu"),
                                           _tb(chosen), _tb(rejected))
    np.testing.assert_allclose(tloss.item(), float(jloss), rtol=LOSS_TOL, atol=LOSS_TOL)
    np.testing.assert_allclose(tmetrics["prob"].item(), float(jmetrics["prob"]), rtol=LOSS_TOL,
                               atol=LOSS_TOL)
    _assert_grads(tgrads, jgrads)
    return tgrads, (tfn, tcfg, tr, frozen, trainable, chosen, rejected)


def test_lora_and_merger_grads_match_jax():
    grads, _ = _compare("lora")
    assert set(grads["lora"]) == set(tlora.QWEN_TARGETS)
    for name in tlora.QWEN_TARGETS:
        assert float(grads["lora"][name]["a"].abs().max()) > 0, name
    for leaf in ("ln_q",):
        assert float(grads["projector"][leaf].abs().max()) > 0
    assert float(grads["projector"]["fc1"]["kernel"].abs().max()) > 0


def test_full_finetune_grads_match_jax():
    grads, _ = _compare("full")
    blocks = grads["backbone"]["visual"]["blocks"]
    # both vision blocks (one window block, one full block) take a gradient
    assert all(float(blocks["qkv"]["kernel"][i].abs().max()) > 0 for i in range(2))
    assert float(grads["backbone"]["visual"]["patch_embed"].abs().max()) > 0
    assert float(grads["backbone"]["text"]["layers"]["k_proj"]["bias"].abs().max()) > 0


def test_kernel_route_full_finetune_grads_match_pallas_and_the_reference_route():
    """Lane-aligned config, ``attn_impl="pallas"``: B8's plain version in all
    three mask modes under ``_FlashAttentionCore``, against JAX's interpreted
    kernels; then the port's own reference route from the same state, to
    5e-4 of each leaf's max (two attention formulations in fp32)."""
    tfa.reset_counters()
    grads, (_, tcfg, tr, frozen, trainable, chosen, rejected) = _compare(
        "full", aligned=True, attn_impl="pallas")
    L, depth = tcfg.text.num_layers, tcfg.vision.depth
    # forward + remat recompute per attention; one backward each
    assert tfa.PLAIN_CALLS["fa_hm"] == 2 * (L + depth) and tfa.PLAIN_CALLS["fa_bwd"] == L + depth
    assert tfa.PLAIN_CALLS["prep"] == 0 and not any(tfa.LAUNCHES.values())
    ref_fn = tts.make_pairwise_loss_fn(tcfg, tr, attn_impl="xla", remat=True,
                                       projector_path=QWEN_PATH)
    _, _, ref = _torch_grads(ref_fn, _ttrainable(trainable), to_torch(frozen, "cpu"),
                             _tb(chosen), _tb(rejected))
    n = _assert_grads(grads, jax.tree_util.tree_map(lambda t: t.detach().numpy(), ref),
                      rtol=5e-4)
    assert n == len(toptim.tree_leaves(trainable))


def test_two_train_steps_match_jax():
    jcfg, tcfg, jr, tr, frozen, trainable = _setup("lora")
    chosen, rejected = _pair(tcfg)
    jtx, ttx = joptim.make_optimizer(1e-3, 10), toptim.make_optimizer(1e-3, 10)
    kw = dict(projector_path=QWEN_PATH)
    jstep = jax.jit(jts.make_train_step(jts.make_pairwise_loss_fn(jcfg, jr, **kw), jtx))
    tstep = tts.make_train_step(tts.make_pairwise_loss_fn(tcfg, tr, **kw), ttx)
    js = jts.init_train_state(_jtree(trainable), jtx)
    ts = tts.init_train_state(to_torch(trainable, "cpu"), ttx)
    jf, tf = _jtree(frozen), to_torch(frozen, "cpu")
    for _ in range(2):
        js, jm = jstep(js, jf, _jb(chosen), _jb(rejected), None)
        ts, tm = tstep(ts, tf, _tb(chosen), _tb(rejected))
        np.testing.assert_allclose(tm["preference_loss"].item(), float(jm["preference_loss"]),
                                   rtol=LOSS_TOL, atol=LOSS_TOL)
        np.testing.assert_allclose(tm["grad_norm"].item(), float(jm["grad_norm"]),
                                   rtol=GRAD_RTOL)
    tnp = to_numpy(ts.trainable)
    for path, j in _paths(_np(js.trainable)):
        np.testing.assert_allclose(_get(tnp, path), j, rtol=STEP_TOL, atol=STEP_TOL,
                                   err_msg="/".join(path))
    # the first step's lr is 0 (warmup); the second moves LoRA and merger
    assert not np.array_equal(tnp["lora"]["q_proj"]["a"], trainable["lora"]["q_proj"]["a"])
    assert not np.array_equal(tnp["projector"]["ln_q"], trainable["projector"]["ln_q"])


def test_trainable_tower_grads_through_u8_patches():
    """u8 patches are normalised on the device inside ``vision_forward``; the
    tower's gradients must be those of the host-normalised f32 patches."""
    _, tcfg, _, tr, frozen, trainable = _setup("full")
    fn = tts.make_pairwise_loss_fn(tcfg, tr, projector_path=QWEN_PATH)
    out = []
    for host in (False, True):
        pair = _pair(tcfg, u8=True)
        if host:
            for f in pair:
                f["pixel_values"] = np.stack([tcollate._host_norm(p, v) for p, v in
                                              zip(f["pixel_values"], f["patch_valid"])])
        else:
            assert pair[0]["pixel_values"].dtype == np.uint8
        out.append(_torch_grads(fn, _ttrainable(trainable), frozen, *map(_tb, pair)))
    torch.testing.assert_close(out[0][0], out[1][0], rtol=1e-5, atol=1e-6)
    for path, g in _paths(out[1][2]):
        bound = 1e-4 * float(g.abs().max()) + 1e-9
        assert float((_get(out[0][2], path) - g).abs().max()) <= bound, path


@pytest.mark.parametrize("mode", ["lora", "full"])
def test_fp32_trainables_over_a_bf16_backbone_train(mode):
    """The card's layout: bf16 backbone, fp32 heads, LoRA and merger. Every
    trainable leaf gets a finite gradient of its own dtype and one
    ``make_train_step`` step runs."""
    _, tcfg, _, tr, frozen, trainable = _setup(mode)
    bf = lambda tree: toptim.tree_map(lambda t: t.to(torch.bfloat16), tree)  # noqa: E731
    frozen = {k: bf(to_torch(v, "cpu")) for k, v in frozen.items()}
    tt = to_torch(trainable, "cpu")
    if mode == "full":
        tt["backbone"] = bf(tt["backbone"])
    chosen, rejected = map(_tb, _pair(tcfg, u8=True))
    tx = toptim.make_optimizer(1e-3, 10)
    step = tts.make_train_step(tts.make_pairwise_loss_fn(tcfg, tr, projector_path=QWEN_PATH), tx)
    state = tts.init_train_state(tt, tx)
    for _ in range(2):
        state, m = step(state, frozen, chosen, rejected)
    assert np.isfinite(m["preference_loss"].item()) and m["grad_norm"].item() > 0
    for (path, new), (_, old) in zip(_paths(state.trainable), _paths(tt)):
        assert new.dtype == old.dtype and bool(torch.isfinite(new).all()), path
