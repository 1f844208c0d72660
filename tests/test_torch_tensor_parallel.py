"""Tensor parallelism over the mesh's tp axis: the port on several gloo
processes against the JAX package on one device (fp32 on the CPU).

Every case launches its ranks as subprocesses (``test_torch_multiprocess._launch``:
each launch killed after its deadline). The trees are JAX ``init_params``
trees carried across by ``io/convert.py``.

- (a) rewards: the tiny phi3v of tests/test_tp_and_eval_harness.py (4 heads,
  width 64) scored by ``python -m llava_reward_torch.dryrun score`` on tp 2,
  tp 4 and fsdp 2 x tp 2, on the reference and the kernel route (their plain
  versions here), equal JAX's unsharded forward within that test's rtol 1e-4
  / atol 1e-5;
- (b) one LoRA step (``dryrun step``) with SkipCA, the projector and, for
  phi3v, vision LoRA: phi3v on tp 2 and fsdp 2 x tp 2, qwen and LLaVA on
  tp 2, held to JAX's ``make_train_step`` with tests/test_torch_multiprocess.py's
  bounds (loss within 2.03e-05, grad_norm within GRAD_RTOL, every updated
  leaf within UPDATE_RTOL of its largest update); (c) a full fine-tuning
  step on qwen through its vision tower on tp 2 (the vision qkv's head-aligned
  blocks and its sliced bias);
- (d) the train CLI on tp 2 (phi3v full fine-tuning, the fused qkv_proj and
  gate_up_proj split): its train-state checkpoint holds the JAX layout (the
  one-process run's state within 1e-5), the JAX loader reads its exported
  backbone, it resumes in one process, and a one-process checkpoint resumes
  on tp 2 and writes the one-process artifact bit for bit;
- (e) with no process group, for ``Mesh(1, 1, tp, rank=r)`` and every r:
  each rank's block of every unfused tp-split leaf is the JAX
  ``NamedSharding`` shard, the fused leaves hold [q_r | k_r | v_r] and
  [gate_r | up_r], and the blocks of all ranks assemble to the tree bit for
  bit.

Every launched rank computes on one thread (``OMP_NUM_THREADS=1``), so that
a launch repeats itself bit for bit.

JAX twin: tests/test_tp_and_eval_harness.py:17-47.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding

import test_torch_llava as tllava
import test_torch_qwen_train as tqwen
from llava_reward_tpu.core.config import RewardConfig as JRewardConfig
from llava_reward_tpu.core.config import phi3v_tiny_config
from llava_reward_tpu.io.hf_phi3v import params_from_hf_state_dict as j_from_hf
from llava_reward_tpu.io.torch_io import load_torch_state_dict as j_load_sd
from llava_reward_tpu.lora import lora as jlora
from llava_reward_tpu.models import phi3v as jphi3v
from llava_reward_tpu.parallel import sharding as js
from llava_reward_tpu.reward.model import RewardBatch as JBatch
from llava_reward_tpu.reward.model import init_head_params as j_init_head
from llava_reward_tpu.reward.model import reward_forward as j_reward_forward
from llava_reward_tpu.train import optim as joptim
from llava_reward_tpu.train import train_step as jts
from llava_reward_torch import train_llava_reward as t_train_cli
from llava_reward_torch.core import config as tconfig
from llava_reward_torch.io.convert import to_torch
from llava_reward_torch.parallel import sharding as ts
from test_torch_multiprocess import (CFG, F32_EPS, GRAD_RTOL, LOSS_TOL, N_IMG, PAIRS, RCFG,
                                     UPDATE_RTOL, _batch, _get, _launch, _nonzero_b, _np, _paths,
                                     _summary)
# autouse here too: on several threads the phi3v steps' updated leaves
# differed from launch to launch, and fsdp 2 x tp 2's projector/fc2/bias
# once read 1.01x its update bound
from test_torch_multiprocess import _one_thread_a_rank  # noqa: F401
from test_torch_sharding import _flat, _jflat, _trees

REWARD_RTOL, REWARD_ATOL = 1e-4, 1e-5  # tests/test_tp_and_eval_harness.py:47


def _torch_fields(fields):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in fields.items() if v is not None}


def _run(kind, n, spec, tmp_path):
    """``dryrun <kind>`` of ``spec`` on ``n`` gloo ranks -> each rank's output."""
    torch.save(spec, tmp_path / f"{kind}.pt")
    _launch(n, ["-m", "llava_reward_torch.dryrun", kind, str(tmp_path / f"{kind}.pt"),
                str(tmp_path / f"{kind}.out"), "--device", "cpu"])
    return [torch.load(tmp_path / f"{kind}.out.{r}", weights_only=True) for r in range(n)]


# ---------------------------------------------------------------- (a) rewards

SCORE_CFG = dict(num_crops=4, num_layers=2, vision_layers=1, hidden_size=64, num_heads=4)
SCORE_MESHES = {"tp2": (2, {"mesh_tp": 2}), "tp4": (4, {"mesh_tp": 4}),
                "fsdp2xtp2": (4, {"mesh_tp": 2})}


@pytest.fixture(scope="module")
def score_setup():
    cfg = phi3v_tiny_config(**SCORE_CFG)
    rcfg = dict(is_general_preference=True, value_head_dim=2, layer_id=cfg.decoder.num_layers)
    jr = JRewardConfig(**rcfg)
    params = _np({"backbone": jphi3v.init_params(jax.random.PRNGKey(0), cfg),
                  "head": j_init_head(jax.random.PRNGKey(1), cfg, jr)})
    rng = np.random.default_rng(0)
    B, S = 8, 32
    batch = {"input_ids": rng.integers(2, 100, (B, S)).astype(np.int32),
             "attention_mask": np.ones((B, S), np.int32)}
    batch["attention_mask"][5, :7] = 0  # one left-padded row
    jb = JBatch(input_ids=jnp.asarray(batch["input_ids"]),
                attention_mask=jnp.asarray(batch["attention_mask"]), pixel_values=None,
                img_gather_idx=None, splice_idx=None, num_img_tokens=None)
    ref = np.asarray(jax.jit(lambda p, b: j_reward_forward(
        p, cfg, jr, b, training=False, attn_impl="xla").reward)(
        jax.tree_util.tree_map(jnp.asarray, params), jb))
    return rcfg, params, batch, ref


@pytest.mark.parametrize("mesh_key", list(SCORE_MESHES))
def test_tp_rewards_match_the_jax_unsharded_forward(score_setup, mesh_key, tmp_path):
    rcfg, params, batch, ref = score_setup
    n, mesh = SCORE_MESHES[mesh_key]
    outs = _run("score", n, {"family": "phi3v", "cfg": SCORE_CFG, "rcfg": rcfg, "mesh": mesh,
                             "params": to_torch(params, "cpu"), "batches": [_torch_fields(batch)],
                             "impls": ("xla", "pallas")}, tmp_path)
    assert outs[0]["mesh"]["tp"] == mesh["mesh_tp"]
    for impl in ("xla", "pallas"):
        by_data = {}
        for o in outs:  # the tp peers of a data rank score its rows alike
            r = o["rewards"][impl][0].numpy()
            if o["data_index"] in by_data:
                np.testing.assert_array_equal(r, by_data[o["data_index"]])
            by_data[o["data_index"]] = r
        got = np.concatenate([by_data[d] for d in sorted(by_data)])
        np.testing.assert_allclose(got, ref, rtol=REWARD_RTOL, atol=REWARD_ATOL, err_msg=impl)


# ---------------------------------------------------------------- (b, c) steps

OPTIM = dict(lr=1.0, total_steps=10, eps=1.0, warmup_ratio=0.0)


def _phi3v_case():
    cfg = phi3v_tiny_config(**CFG)
    backbone = _np(jphi3v.init_params(jax.random.PRNGKey(0), cfg))
    trainable = {
        "head": _np(j_init_head(jax.random.PRNGKey(1), cfg, JRewardConfig(**RCFG))),
        "lora": _nonzero_b(_np(jlora.init_lora(jax.random.PRNGKey(2), cfg.decoder, 4, 8)), 3),
        "vision_lora": _nonzero_b(
            _np(jlora.init_vision_lora(jax.random.PRNGKey(4), cfg.vision, 4, 8)), 5),
        "projector": backbone["vision"]["img_projection"],
    }
    pads = (0, 21, 5, 0)
    chosen = _batch(cfg, 1, pads, (N_IMG, 200, 250, 150))
    rejected = _batch(cfg, 2, pads[::-1], (150, N_IMG, 200, 250))
    jb = lambda f: JBatch(**{k: jnp.asarray(v) for k, v in f.items()})  # noqa: E731
    return cfg, CFG, RCFG, {"backbone": backbone}, trainable, chosen, rejected, jb


def _qwen_case(mode):
    jcfg, _, jr, _, frozen, trainable = tqwen._setup(mode)
    chosen, rejected = tqwen._pair(jcfg)
    rcfg = dict(tqwen.GPM, layer_id=jcfg.text.num_layers)
    return (jcfg, dict(num_layers=2, vision_depth=2), rcfg, frozen, trainable, chosen,
            rejected, tqwen._jb)


def _llava_case():
    jcfg, tcfg, _, _, frozen, trainable = tllava._setup_lora()
    chosen, rejected = tllava._pair_fields(tcfg, [(50, 900), (120, 700)], seed=1)
    rcfg = dict(tllava.GPM, layer_id=jcfg.text.num_layers)
    return jcfg, {}, rcfg, frozen, trainable, chosen, rejected, tllava._jb


STEP_CASES = {
    "phi3v_tp2": ("phi3v", _phi3v_case, 2),
    "phi3v_fsdp2xtp2": ("phi3v", _phi3v_case, 4),
    "qwen_tp2": ("qwen", lambda: _qwen_case("lora"), 2),
    "llava_tp2": ("llava", _llava_case, 2),
    "qwen_full_tp2": ("qwen", lambda: _qwen_case("full"), 2),
}


@pytest.mark.parametrize("case", list(STEP_CASES))
def test_tp_step_takes_the_jax_single_device_step(case, tmp_path):
    family, make, n = STEP_CASES[case]
    jcfg, cfg_kw, rcfg, frozen, trainable, chosen, rejected, jb = make()
    loss = {"remat": True}
    jfn = jts.make_pairwise_loss_fn(jcfg, JRewardConfig(**rcfg), attn_impl="xla",
                                    projector_path=jts.PROJECTOR_PATHS[family], **loss)
    jtx = joptim.make_optimizer(**OPTIM)
    jt = lambda tree: jax.tree_util.tree_map(jnp.asarray, tree)  # noqa: E731
    js_, jm = jax.jit(jts.make_train_step(jfn, jtx))(
        jts.init_train_state(jt(trainable), jtx), jt(frozen), jb(chosen), jb(rejected), None)

    outs = _run("step", n, {
        "family": family, "cfg": cfg_kw, "rcfg": rcfg, "mesh": {"mesh_tp": 2}, "optim": OPTIM,
        "loss": loss, "frozen": to_torch(frozen, "cpu"), "trainable": to_torch(trainable, "cpu"),
        "chosen": _torch_fields(chosen), "rejected": _torch_fields(rejected)}, tmp_path)
    for o in outs[1:]:  # every rank: the same metrics and the same gathered tree
        assert o["metrics"] == outs[0]["metrics"]
        for path, t in _paths(outs[0]["trainable"]):
            assert torch.equal(_get(o["trainable"], path), t), path
    m = outs[0]["metrics"]
    assert outs[0]["mesh"] == {"dp": 1, "fsdp": n // 2, "tp": 2}
    assert abs(m["preference_loss"] - float(jm["preference_loss"])) <= LOSS_TOL
    assert m["grad_norm"] == pytest.approx(float(jm["grad_norm"]), rel=GRAD_RTOL)
    for path, j in _paths(_np(js_.trainable)):
        t = _get(outs[0]["trainable"], path).numpy()
        upd_j, upd_t = j - _get(trainable, path), t - _get(trainable, path)
        bound = UPDATE_RTOL * np.abs(upd_j).max() + 2 * F32_EPS * np.abs(j).max()
        assert np.abs(upd_t - upd_j).max() <= bound, "/".join(path)
    # the tp-split trainable leaves were held in blocks
    shapes, fsdp = outs[0]["local_shapes"], n // 2
    whole = dict((("/".join(p), t.shape) for p, t in _paths(trainable)))
    w_q = "head/skipca/W_q/kernel"
    if w_q in whole:
        assert shapes[w_q] == (whole[w_q][0] // fsdp, whole[w_q][1] // 2)
    if "backbone" in trainable:
        for name, dim in (("backbone/visual/blocks/qkv/kernel", 2),
                          ("backbone/text/layers/o_proj/kernel", 1)):
            want = list(whole[name])
            want[dim] //= 2
            assert shapes[name] == tuple(want), name


# ---------------------------------------------------------------- (d) the CLI

CLI = ["--model_type", "phi3v", "--max_epochs", "1", "--seq_len", "1024",
       "--is_general_preference", "--value_head_dim", "2", "--lora_rank", "0",
       "--micro_train_batch_size", "2", "--num_workers", "1", "--logging_steps", "1",
       "--train_split_ratio", "1.0", "--dataset", PAIRS, "--device", "cpu"]


@pytest.fixture(scope="module")
def tp_cli(tmp_path_factory):
    d = tmp_path_factory.mktemp("tp_cli")
    outs = _launch(2, ["-m", "llava_reward_torch.train_llava_reward", *CLI, "--mesh_tp", "2",
                       "--save_path", str(d / "save2"), "--ckpt_path", str(d / "ckpt2")])
    one = t_train_cli.main([*CLI, "--save_path", str(d / "save1"), "--ckpt_path",
                            str(d / "ckpt1")])
    return d, outs, one


def test_tp_checkpoint_is_the_jax_layout_and_resumes_both_ways(tp_cli):
    d, outs, one = tp_cli
    s = [_summary(o) for o in outs]
    assert [x["mesh"] for x in s] == [{"dp": 1, "fsdp": 1, "tp": 2}] * 2
    assert s[0]["rows"] == s[1]["rows"] == [int(i) for i in one.train_loader.sampler]
    for k, loss in enumerate(s[0]["losses"]):
        assert abs(loss - one.train_logs[k]["preference_loss"]) <= LOSS_TOL
    state = torch.load(d / "ckpt2" / "train_state.pt", weights_only=True)
    n = 0
    for path, t in _paths(state["trainable"]):
        want = _get(ts.gather_tree(one.state.trainable), path)
        assert t.shape == want.shape, path
        torch.testing.assert_close(t, want, rtol=0, atol=1e-5, msg="/".join(path))
        n += "qkv_proj" in path or "gate_up_proj" in path
    assert n == 2
    # the JAX loader reads the exported backbone: the checkpoint's, in bf16
    cfg = phi3v_tiny_config()
    jb = _np(j_from_hf(j_load_sd(str(d / "save2" / "epoch_0" / "full_model")), cfg))
    for name in ("qkv_proj", "gate_up_proj", "o_proj"):
        got = jb["decoder"]["layers"][name]
        want = state["trainable"]["backbone"]["decoder"]["layers"][name].bfloat16().float()
        np.testing.assert_array_equal(got, want.numpy(), err_msg=name)

    resumed = t_train_cli.main([*CLI, "--load_checkpoint", "--save_path", str(d / "save_r"),
                                "--ckpt_path", str(d / "ckpt2")])
    for path, t in _paths(state["trainable"]):
        assert torch.equal(_get(resumed.state.trainable, path), t), path
    outs = _launch(2, ["-m", "llava_reward_torch.train_llava_reward", *CLI, "--mesh_tp", "2",
                       "--load_checkpoint", "--save_path", str(d / "save_r2"),
                       "--ckpt_path", str(d / "ckpt1")])
    assert [_summary(o)["steps"] for o in outs] == [one.state.step] * 2
    for name in ("pytorch_model.bin", os.path.join("full_model", "pytorch_model.bin")):
        got = torch.load(d / "save_r2" / "epoch_0" / name, weights_only=True)
        want = torch.load(d / "save1" / "epoch_0" / name, weights_only=True)
        assert got.keys() == want.keys()
        for k in want:
            assert torch.equal(got[k], want[k]), k


# ---------------------------------------------------------------- (e) shards

SHARD_CASES = [("phi3v", 2), ("phi3v", 4), ("qwen", 2), ("llava", 2)]
TCFGS = {"phi3v": lambda: tconfig.phi3v_tiny_config(num_crops=1),
         "qwen": lambda: tconfig.qwen_tiny_config(num_layers=2, vision_depth=2),
         "llava": lambda: tconfig.llava_tiny_config(num_layers=2, vision_layers=2)}
FUSED = {"backbone/decoder/layers/qkv_proj": 3, "backbone/decoder/layers/gate_up_proj": 2,
         "backbone/visual/blocks/qkv/kernel": 3}


@pytest.fixture(scope="module")
def shard_trees():
    return {k: (v, to_torch(v, "cpu")) for k, v in _trees().items() if k in TCFGS}


@pytest.mark.parametrize("name, tp", SHARD_CASES, ids=[f"{n}_tp{t}" for n, t in SHARD_CASES])
def test_each_tp_rank_holds_its_heads(shard_trees, name, tp):
    jtree, ttree = shard_trees[name]
    jm = js.create_mesh(dp=1, fsdp=1, tp=tp, devices=jax.devices()[:tp])
    jleaves, jspecs = _jflat(jtree), _jflat(js.param_specs(jtree))
    blocks = {}
    for rank in range(tp):
        local = _flat(ts.shard_params(ttree, ts.Mesh(1, 1, tp, rank=rank), TCFGS[name]()))
        for path, leaf in jleaves.items():
            got = local[path]
            block = got.local if isinstance(got, ts.Sharded) else got
            blocks.setdefault(path, []).append(block)
            spec = js._divisible_spec(jspecs[path], leaf, jm)
            if path in FUSED:
                # [p0_r | p1_r | ...]: each part's own r-th slice
                whole = np.asarray(leaf)
                parts = np.split(whole, FUSED[path], axis=-1)
                want = np.concatenate([np.split(p, tp, axis=-1)[rank] for p in parts], -1)
            else:
                sharding = NamedSharding(jm, spec)
                want = np.asarray(leaf)[sharding.devices_indices_map(leaf.shape)[
                    jax.devices()[rank]]]
            np.testing.assert_array_equal(block.detach().numpy(), want, err_msg=path)
            assert isinstance(got, ts.Sharded) == ("tp" in tuple(spec)), path
    assert any(p in FUSED for p in jleaves) or name == "llava"
    for path, bs in blocks.items():  # every rank's block assembles to the leaf
        spec = tuple(js._divisible_spec(jspecs[path], jleaves[path], jm))
        if "tp" not in spec:
            assert all(b is bs[0] for b in bs), path
            continue
        d = spec.index("tp")
        k = FUSED.get(path, 1)
        pieces = [np.split(b.detach().numpy(), k, axis=d) for b in bs]
        whole = np.concatenate([np.concatenate([p[j] for p in pieces], d) for j in range(k)], d)
        np.testing.assert_array_equal(whole, np.asarray(jleaves[path]), err_msg=path)
