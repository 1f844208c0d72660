"""A quantized frozen decoder under tensor parallelism: the port on gloo
processes (fp32 on the CPU) against the JAX package on one device.

The decoders are quantized by the JAX ``quantize_stacked_layers`` (every
leaf, min_size 0) as W8A8, NF4 and absmax int4, and carried across by
``io/convert.py``. The launches follow tests/test_torch_tensor_parallel.py
(``_run``: ``python -m llava_reward_torch.dryrun`` on gloo ranks, each
launch killed after its deadline).

- (a) with no process group, for ``Mesh(1, 1, tp, rank=r)`` at tp 2 and 4
  and every r: each rank's block of every split quantized leaf (W8A8 codes
  K-major), and the blocks of all ranks reassembled, fused parts in
  [q_r | k_r | v_r] / [gate_r | up_r] order, equal to the JAX tree bit for
  bit; the per-column scale of a row-split W8A8 / int4 leaf stays whole;
- (b) B6's and B5's plain versions in their tp modes: each rank's raw
  absmax of its columns, MAX-reduced, then its codes on that amax, give the
  whole row's codes bit for bit (a zero row, a row zero on one rank's
  columns, the row's max on one rank);
- (c) ``dryrun score`` of a W8A8 phi3v tree, and of a qwen tree on the fused
  inference layout, on tp 2 through the kernel route (``attn_impl``
  "pallas", whose plain versions run here: B4, B5 and B6 in their tp modes,
  the GEMM on each rank's block): the rewards JAX's one-device W8A8 forward
  within tests/test_torch_quant_kernels.py's REWARD_TOL, every decision the
  same;
- (d) one LoRA step (``dryrun step``) over W8A8, NF4 and absmax decoders,
  phi3v, qwen and LLaVA on tp 2, against JAX's one-device step under
  tests/test_torch_quant_train.py's bounds (loss: LOSS_TOL for NF4,
  W8A8_LOSS_TOL for the others; grad_norm and every leaf's update, as a
  relative L2 error: NF4_REL / W8A8_REL). The configs are the tiny ones at
  hidden 128 and MLP width 256 (qwen 8 heads), so that each rank's rows of a
  row-split NF4 projection hold whole 64-row blocks;
- (e) the train CLI with ``--load_in_8bit --mesh_tp 2`` on two ranks (every
  leaf quantized, as in tests/test_torch_cli.py) against one process: the
  same losses within PARITY.md's 2.03e-05, the artifact with the same keys
  and shapes within the tp CLI test's 1e-5, each rank holding half of the
  decoder's code bytes.
"""

import dataclasses
import os
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_llava as tllava
import test_torch_qwen_model as tqm
import test_torch_qwen_train as tqwen
import test_torch_quant_train as tquant_train
from llava_reward_tpu.core.config import RewardConfig as JRewardConfig
from llava_reward_tpu.core.config import llava_tiny_config, phi3v_tiny_config, qwen_tiny_config
from llava_reward_tpu.lora import lora as jlora
from llava_reward_tpu.models import llava_next as jllava
from llava_reward_tpu.models import phi3v as jphi3v
from llava_reward_tpu.models import qwen25_vl as jqwen
from llava_reward_tpu.reward.model import RewardBatch as JBatch
from llava_reward_tpu.reward.model import init_head_params as j_init_head
from llava_reward_tpu.reward.model import reward_forward as j_reward_forward
from llava_reward_tpu.train import optim as joptim
from llava_reward_tpu.train import train_step as jts
from llava_reward_tpu.utils import quantize as jquant
from llava_reward_torch import train_llava_reward as t_train_cli
from llava_reward_torch.core import config as tconfig
from llava_reward_torch.io.convert import to_torch
from llava_reward_torch.ops import quant_epilogue as tqe
from llava_reward_torch.parallel import sharding as ts
from llava_reward_torch.utils import quantize as tquant
from test_torch_multiprocess import (F32_EPS, LOSS_TOL as PARITY_TOL, N_IMG, PAIRS, _batch,
                                     _get, _launch, _nonzero_b, _np, _paths, _summary)
from test_torch_quant_kernels import REWARD_TOL
from test_torch_quant_train import LOSS_TOL, NF4_REL, SCHEMES, W8A8_LOSS_TOL, W8A8_REL
from test_torch_tensor_parallel import OPTIM, _run, _torch_fields

ROW_SPLIT = ("o_proj", "down_proj")
# the tiny configs' arguments (both packages'), widened so that a tp rank's
# rows of a row-split NF4 projection hold whole 64-row blocks
WIDE = {
    "phi3v": dict(num_crops=1, hidden_size=128, intermediate_size=256),
    "qwen": dict(num_layers=2, vision_depth=2, hidden_size=128, num_heads=8),
    "llava": dict(hidden_size=128),
}
JCFG = {"phi3v": phi3v_tiny_config, "qwen": qwen_tiny_config, "llava": llava_tiny_config}
TCFG = {"phi3v": tconfig.phi3v_tiny_config, "qwen": tconfig.qwen_tiny_config,
        "llava": tconfig.llava_tiny_config}


@pytest.fixture(autouse=True)
def _one_thread_a_rank(monkeypatch):
    """Each launched rank computes on one thread: on several, its CPU sums
    vary in their last bit from run to run, which the int8 codes of the W8A8
    routes then carry on (a flipped code); on one, a run repeats itself."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")


def _start(kind, spec, tmp_path):
    """``_run`` of ``spec`` on two ranks in a thread, which waits on the
    subprocesses while this one computes the JAX side; ``.result()``."""
    pool = ThreadPoolExecutor(1)
    try:
        return pool.submit(_run, kind, 2, spec, tmp_path)
    finally:
        pool.shutdown(wait=False)


def _quantized(backbone, scheme, fuse=False):
    """``backbone`` with its decoder's stacked layers quantized by JAX (every
    leaf), the qwen layout fused after it as the adaptor fuses it."""
    dec = "decoder" if "decoder" in backbone else "text"
    layers = _np(jquant.quantize_stacked_layers(backbone[dec]["layers"], min_size=0,
                                                **SCHEMES[scheme]))
    if fuse:
        layers = _np(jqwen.fuse_decoder_projections(layers))
    return {**backbone, dec: {**backbone[dec], "layers": layers}}


def _backbone(family, jcfg, seed=0):
    if family == "phi3v":
        return _np(jphi3v.init_params(jax.random.PRNGKey(seed), jcfg))
    if family == "qwen":
        return tqm.jax_tree(jcfg, seed)
    return _np(jllava.init_params(jax.random.PRNGKey(seed), jcfg))


# ---------------------------------------------------------------- (a) blocks

BLOCK_CASES = [("phi3v", 2), ("phi3v", 4), ("qwen", 2), ("llava", 2), ("llava", 4)]
# tp 4 needs 4 * 64 rows in each row-split NF4 projection
BLOCK_CFG = {**WIDE, "phi3v": dict(WIDE["phi3v"], hidden_size=256),
             "llava": dict(hidden_size=256)}


def _qpaths(tree, prefix=()):
    """(path, quantized leaf) of every quantized dict in ``tree``."""
    for k, v in tree.items():
        if isinstance(v, dict) and (tquant.is_quantized(v) or tquant.is_w8a8(v)):
            yield prefix + (k,), v
        elif isinstance(v, dict):
            yield from _qpaths(v, prefix + (k,))


@pytest.mark.parametrize("scheme", list(SCHEMES))
@pytest.mark.parametrize("family, tp", BLOCK_CASES, ids=[f"{f}_tp{t}" for f, t in BLOCK_CASES])
def test_each_tp_rank_holds_its_block_of_the_quantized_leaves(family, tp, scheme, monkeypatch):
    jcfg, tcfg = JCFG[family](**BLOCK_CFG[family]), TCFG[family](**BLOCK_CFG[family])
    jtree = {"backbone": _quantized(_backbone(family, jcfg), scheme)}
    ttree = to_torch(jtree, "cpu")
    dec = jcfg.decoder if family == "phi3v" else jcfg.text
    fused = {"qkv_proj": (dec.q_size, dec.kv_size, dec.kv_size),
             "gate_up_proj": (dec.intermediate_size,) * 2}
    locals_ = [ts.shard_params(ttree, ts.Mesh(1, 1, tp, rank=r), tcfg) for r in range(tp)]
    n = 0
    for path, jleaf in _qpaths(jtree):
        name = next(p for p in reversed(path) if p.endswith("_proj"))
        rows = name in ROW_SPLIT
        for key, whole in jleaf.items():
            got = [_get(t, path)[key] for t in locals_]
            if rows and key == "scale" and scheme != "nf4":  # one scale per out column
                assert all(g is _get(ttree, path)[key] for g in got), (path, key)
                continue
            blocks = [g.local for g in got]
            assert all(isinstance(g, ts.Sharded) and g.dims == {"tp": whole.ndim - 1 - rows}
                       for g in got), (path, key)
            if key == tquant.W8A8_KEY:  # K-major, in storage of its own
                assert all(b.stride()[-2:] == (1, b.shape[-2]) and b.mT.is_contiguous()
                           for b in blocks), path
            bs = [b.numpy() for b in blocks]
            if rows:
                want = np.split(whole, tp, axis=-2)
                np.testing.assert_array_equal(np.concatenate(bs, -2), whole, err_msg=str(path))
            else:
                widths = fused.get(name, (whole.shape[-1],))
                cut = np.cumsum(widths)[:-1]
                parts = np.split(whole, cut, axis=-1)
                want = [np.concatenate([np.split(p, tp, axis=-1)[r] for p in parts], -1)
                        for r in range(tp)]
                pieces = [np.split(b, np.cumsum([w // tp for w in widths])[:-1], axis=-1)
                          for b in bs]
                back = np.concatenate([np.concatenate([p[j] for p in pieces], -1)
                                       for j in range(len(widths))], -1)
                np.testing.assert_array_equal(back, whole, err_msg=str(path))
            for r in range(tp):
                np.testing.assert_array_equal(bs[r], want[r], err_msg=f"{path} {key} rank {r}")
            # ``full`` (gather_tree, saving) gives the whole leaf in the JAX
            # layout, W8A8 codes K-major: the tp all-gather stood in for by
            # the ranks' blocks in order
            monkeypatch.setattr(ts, "gather_whole", lambda x, d, g: torch.cat(blocks, d))
            monkeypatch.setattr(ts.Mesh, "group", lambda self, axes: None)
            full = got[0].full()
            np.testing.assert_array_equal(full.numpy(), whole, err_msg=f"{path} {key} full")
            assert (full.stride()[-2:] == (1, full.shape[-2]) if key == tquant.W8A8_KEY
                    else full.is_contiguous()), (path, key)
            n += 1
    assert n >= 6  # every projection's codes, and the split scales


# ---------------------------------------------------------------- (b) given amax


@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("kernel", ["row_quant", "silu_mul_quant"])
def test_the_tp_global_amax_gives_the_whole_rows_codes(kernel, tp):
    rng = np.random.default_rng(tp)
    K = 64 * tp
    x = torch.from_numpy(rng.standard_normal((6, 2 * K if kernel == "silu_mul_quant" else K))
                         .astype(np.float32))
    x[1] = 0  # a zero row: amax := 1 on every rank
    x[2, :K // tp] = 0  # zero on rank 0's columns only
    x[3, :K // tp] = 0
    x[3, K // tp] = 40.0  # the row's max on rank 1
    if kernel == "silu_mul_quant":
        whole, w_amax = tqe.silu_mul_quant_plain(x)
        blocks = [torch.cat([p.chunk(tp, -1)[r] for p in x.chunk(2, -1)], -1) for r in range(tp)]
        absmax, quant = tqe.silu_mul_absmax_plain, tqe.silu_mul_quant_plain
    else:
        whole, w_amax = tqe.row_quant_plain(x)
        blocks = list(x.chunk(tp, -1))
        absmax, quant = tqe.row_absmax_plain, tqe.row_quant_plain
    local = [absmax(b) for b in blocks]
    assert float(local[0][2]) == 0.0  # the raw absmax: no amax := 1
    amax = torch.stack(local).amax(0)  # the MAX all-reduce
    codes = [quant(b, amax) for b in blocks]
    assert torch.equal(torch.cat([c for c, _ in codes], -1), whole)
    assert all(torch.equal(a, w_amax) for _, a in codes)


# ---------------------------------------------------------------- (c) scoring

SCORE_B, SCORE_S = 8, 32


def _score_tree(family):
    """A W8A8 tree (phi3v; qwen on the fused inference layout) with a scalar
    value head, and its JAX config and reward config."""
    jcfg = JCFG[family](**WIDE[family])
    L = (jcfg.decoder if family == "phi3v" else jcfg.text).num_layers
    rcfg = dict(is_general_preference=False, value_head_dim=1, layer_id=L)
    params = {"backbone": _quantized(_backbone(family, jcfg), "w8a8", fuse=family == "qwen"),
              "head": _np(j_init_head(jax.random.PRNGKey(1), jcfg, JRewardConfig(**rcfg)))}
    return jcfg, rcfg, params


@pytest.mark.parametrize("family", ["phi3v", "qwen"])
def test_w8a8_scoring_on_tp2_matches_the_jax_one_device_forward(family, tmp_path):
    jcfg, rcfg, params = _score_tree(family)
    dec = jcfg.decoder if family == "phi3v" else jcfg.text
    rng = np.random.default_rng(0)
    batch = {"input_ids": rng.integers(2, 100, (SCORE_B, SCORE_S)).astype(np.int32),
             "attention_mask": np.ones((SCORE_B, SCORE_S), np.int32)}
    batch["attention_mask"][5, :7] = 0  # one left-padded row
    if family == "qwen":  # text-only M-RoPE positions
        pos = np.maximum(np.cumsum(batch["attention_mask"], -1) - 1, 0).astype(np.int32)
        batch["position_ids"] = np.broadcast_to(pos, (3, SCORE_B, SCORE_S)).copy()
    ranks = _start("score", {"family": family, "cfg": WIDE[family], "rcfg": rcfg,
                             "mesh": {"mesh_tp": 2}, "params": to_torch(params, "cpu"),
                             "batches": [_torch_fields(batch)], "impls": ("pallas",)}, tmp_path)
    fields = {k: jnp.asarray(v) for k, v in batch.items()}
    jb = JBatch(**{f: fields.get(f) for f in JBatch._fields})
    ref = np.asarray(jax.jit(lambda p, b: j_reward_forward(
        p, jcfg, JRewardConfig(**rcfg), b, training=False, attn_impl="xla").reward)(
        jax.tree_util.tree_map(jnp.asarray, params), jb)).reshape(-1)
    outs = ranks.result()
    got = [o["rewards"]["pallas"][0].numpy().reshape(-1) for o in outs]
    np.testing.assert_array_equal(got[0], got[1])  # the tp peers score alike
    np.testing.assert_allclose(got[0], ref, rtol=0, atol=REWARD_TOL)
    # every decision of the pairs (i, i + B/2) the same, and the pairs show one
    half = SCORE_B // 2
    d_ref, d_got = ref[:half] - ref[half:], got[0][:half] - got[0][half:]
    assert (np.abs(d_ref) > 2 * REWARD_TOL).any(), d_ref
    assert ((d_ref > 0) == (d_got > 0)).all(), (d_ref, d_got)
    # the fused routes on each rank: B4 into qkv and gate_up, o_proj's codes
    # and down's B5 codes on the tp-global amax, four GEMMs a layer
    L = dec.num_layers
    want = {"rms_quant": 2 * L, "silu_mul_quant": 0, "row_quant": 0, "row_absmax": L,
            "row_quant_given": L, "silu_mul_absmax": L, "silu_mul_quant_given": L,
            "int8_matmul": 4 * L}
    for o in outs:
        assert {k: o["plain_calls"][k] for k in want} == want
        assert not any(o["launches"].values())


# ---------------------------------------------------------------- (d) steps


# W8A8 and absmax: tests/test_torch_quant_train.py's cases (its trees,
# pairs and tiny configs, where its bounds were read); NF4 at WIDE
BASE = {"phi3v": dict(num_crops=1), "qwen": dict(num_layers=2, vision_depth=2), "llava": {}}


def _step_case(family, scheme):
    """(port config kwargs, reward config kwargs, JAX config, frozen backbone,
    trainable, chosen, rejected, JAX batch maker) of a LoRA step."""
    if scheme != "nf4":
        jcfg, _, jr, _, frozen, trainable, chosen, rejected, jb, _, _, _ = tquant_train._family(
            family)
        if family == "phi3v":  # the train-step test's field tuples
            chosen, rejected = ({k: v for k, v in zip(JBatch._fields, f)}
                                for f in (chosen, rejected))
            jb = lambda f: JBatch(**{k: jnp.asarray(v) for k, v in f.items()})  # noqa: E731
        return (BASE[family], dataclasses.asdict(jr), jcfg, frozen["backbone"], trainable, chosen,
                rejected, jb)
    jcfg = JCFG[family](**WIDE[family])
    if family == "phi3v":
        rcfg = dict(is_general_preference=True, value_head_dim=2, add_cross_attention=True,
                    layer_id=jcfg.decoder.num_layers)
        lora = jlora.init_lora(jax.random.PRNGKey(2), jcfg.decoder, 4, 8)
        chosen = _batch(jcfg, 1, (0, 21), (N_IMG, 200))
        rejected = _batch(jcfg, 2, (5, 0), (150, N_IMG))
        jb = lambda f: JBatch(**{k: jnp.asarray(v) for k, v in f.items()})  # noqa: E731
    else:
        rcfg = dict(tqwen.GPM, layer_id=jcfg.text.num_layers)
        lora = jlora.init_lora(jax.random.PRNGKey(2), jcfg.text, 4, 8,
                               targets=jlora.QWEN_TARGETS)
        if family == "qwen":
            chosen, rejected = tqwen._pair(jcfg)
            jb = tqwen._jb
        else:
            chosen, rejected = tllava._pair_fields(TCFG[family](**WIDE[family]),
                                                   [(50, 900), (120, 700)], seed=1)
            jb = tllava._jb
    backbone = _backbone(family, jcfg)
    trainable = {"head": _np(j_init_head(jax.random.PRNGKey(1), jcfg, JRewardConfig(**rcfg))),
                 "lora": _nonzero_b(_np(lora), 3)}
    if family != "phi3v":
        trainable["projector"] = (backbone["visual"]["merger"] if family == "qwen"
                                  else backbone["vision"]["projector"])
    return WIDE[family], rcfg, jcfg, backbone, trainable, chosen, rejected, jb


def _rel(a, b):
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)


def _grad(new, old):
    """The gradient of one AdamW step at lr 1, eps 1 (OPTIM) from its update
    u = -g / (|g| + 1)."""
    u = np.float64(new) - np.float64(old)
    return -u / (1 - np.abs(u))


# a LoRA scale leaf is one number a layer, <g_b, b> / scale for any route;
# held to that identity on its own b gradient (as chip_smoke.py holds the
# scale leaves), per layer and relative to ||g_b|| ||b|| / |scale|
SCALE_IDENTITY_TOL = 1e-4


@pytest.mark.parametrize("scheme", list(SCHEMES))
@pytest.mark.parametrize("family", ["phi3v", "qwen", "llava"])
def test_tp2_lora_step_over_a_quantized_decoder_takes_the_jax_step(family, scheme, tmp_path):
    cfg_kw, rcfg, jcfg, backbone, trainable, chosen, rejected, jb = _step_case(family, scheme)
    frozen = {"backbone": _quantized(backbone, scheme)}
    loss = {"remat": True}
    ranks = _start("step", {
        "family": family, "cfg": cfg_kw, "rcfg": rcfg, "mesh": {"mesh_tp": 2},
        "optim": OPTIM, "loss": loss, "frozen": to_torch(frozen, "cpu"),
        "trainable": to_torch(trainable, "cpu"), "chosen": _torch_fields(chosen),
        "rejected": _torch_fields(rejected)}, tmp_path)
    jfn = jts.make_pairwise_loss_fn(jcfg, JRewardConfig(**rcfg), attn_impl="xla",
                                    projector_path=jts.PROJECTOR_PATHS[family], **loss)
    jtx = joptim.make_optimizer(**OPTIM)
    jt = lambda tree: jax.tree_util.tree_map(jnp.asarray, tree)  # noqa: E731
    js_, jm = jax.jit(jts.make_train_step(jfn, jtx))(
        jts.init_train_state(jt(trainable), jtx), jt(frozen), jb(chosen), jb(rejected), None)
    outs = ranks.result()
    assert outs[1]["metrics"] == outs[0]["metrics"]  # the ranks agree exactly
    for path, t in _paths(outs[0]["trainable"]):
        assert torch.equal(_get(outs[1]["trainable"], path), t), path
    assert outs[0]["mesh"] == {"dp": 1, "fsdp": 1, "tp": 2}
    m = outs[0]["metrics"]
    tol, rel = (LOSS_TOL, NF4_REL) if scheme == "nf4" else (W8A8_LOSS_TOL, W8A8_REL)
    assert abs(m["preference_loss"] - float(jm["preference_loss"])) <= tol
    assert m["grad_norm"] == pytest.approx(float(jm["grad_norm"]), rel=rel)
    got = outs[0]["trainable"]
    for name, t in trainable["lora"].items():
        g_b = _grad(got["lora"][name]["b"].numpy(), t["b"])
        g_s = _grad(got["lora"][name]["scale"].numpy(), t["scale"])
        for i, s0 in enumerate(t["scale"]):
            ident = np.sum(g_b[i] * t["b"][i]) / s0
            cond = np.linalg.norm(g_b[i]) * np.linalg.norm(t["b"][i]) / abs(s0)
            assert abs(g_s[i] - ident) <= SCALE_IDENTITY_TOL * cond, (name, i, g_s[i], ident)
    n = 0
    for path, j in _paths(_np(js_.trainable)):
        n += 1
        if path[-1] == "scale" and scheme != "nf4":
            # the int8 routes' code flips (a rank's partial sums round apart
            # from one device's) move this sum with cancellation by more than
            # W8A8_REL of itself; held to the identity above instead
            continue
        # each leaf's update as a relative L2 error, beyond the fp32 rounding
        # of p + update, which both sides store (half an ulp of p each)
        upd_j = j - _get(trainable, path)
        upd_t = _get(outs[0]["trainable"], path).numpy() - _get(trainable, path)
        err = np.linalg.norm(upd_t - upd_j) - F32_EPS * np.linalg.norm(j)
        assert err <= rel * np.linalg.norm(upd_j), ("/".join(path), _rel(upd_t, upd_j))
    assert n == len(list(_paths(trainable)))
    calls = outs[0]["plain_calls"]
    if scheme == "nf4":  # dequantized a layer at a time: no int8 path
        assert calls["int8_matmul"] == 0
    else:  # every row-split projection on the tp-global amax
        assert calls["row_absmax"] == calls["row_quant_given"] > 0


# ---------------------------------------------------------------- (e) the CLI

# the CLI quantizes leaves of at least 1 M elements, which no tiny leaf
# reaches: every leaf here, as tests/test_torch_cli.py patches it in-process
EVERY_LEAF = ("import sys; from llava_reward_torch.utils import quantize as q; "
              "f = q.quantize_stacked_layers; "
              "q.quantize_stacked_layers = lambda *a, **kw: f(*a, **{**kw, 'min_size': 0}); "
              "from llava_reward_torch import train_llava_reward as t; t.main(sys.argv[1:])")
CLI = ["--model_type", "phi3v", "--max_epochs", "1", "--seq_len", "1024",
       "--is_general_preference", "--value_head_dim", "2", "--lora_rank", "4",
       "--lora_alpha", "8", "--ft_projector", "--micro_train_batch_size", "2",
       "--num_workers", "1", "--logging_steps", "1", "--train_split_ratio", "1.0",
       "--dataset", PAIRS, "--device", "cpu", "--load_in_8bit"]
ARTIFACT_TOL = 1e-5  # tests/test_torch_tensor_parallel.py's checkpoint bound


def test_cli_load_in_8bit_on_two_tp_ranks_writes_the_one_rank_artifact(tmp_path, monkeypatch):
    outs = _launch(2, ["-c", EVERY_LEAF, *CLI, "--mesh_tp", "2",
                       "--save_path", str(tmp_path / "save2"),
                       "--ckpt_path", str(tmp_path / "ckpt2")])
    q = tquant.quantize_stacked_layers
    monkeypatch.setattr(tquant, "quantize_stacked_layers",
                        lambda *a, **kw: q(*a, **{**kw, "min_size": 0}))
    one = t_train_cli.main([*CLI, "--save_path", str(tmp_path / "save1"),
                            "--ckpt_path", str(tmp_path / "ckpt1")])
    s = [_summary(o) for o in outs]
    assert [x["mesh"] for x in s] == [{"dp": 1, "fsdp": 1, "tp": 2}] * 2
    assert s[0]["losses"] == s[1]["losses"] and s[0]["rows"] == s[1]["rows"]
    assert len(s[0]["losses"]) == len(one.train_logs) > 0
    for loss, log in zip(s[0]["losses"], one.train_logs):
        assert abs(loss - log["preference_loss"]) <= PARITY_TOL
    whole = t_train_cli._code_bytes(one.frozen["backbone"]["decoder"]["layers"])
    assert whole > 0 and s[0]["code_bytes"] == s[1]["code_bytes"] == whole // 2
    for name in ("pytorch_model.bin", os.path.join("lora", "adapter_model.bin")):
        got = torch.load(tmp_path / "save2" / "epoch_0" / name, weights_only=True)
        want = torch.load(tmp_path / "save1" / "epoch_0" / name, weights_only=True)
        assert got.keys() == want.keys()
        for k in want:
            assert got[k].shape == want[k].shape, k
            torch.testing.assert_close(got[k], want[k], rtol=0, atol=ARTIFACT_TOL, msg=k)
