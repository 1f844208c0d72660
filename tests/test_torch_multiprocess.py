"""The port on several processes (gloo on the CPU) against the JAX package
on one device.

Every case launches its ranks as subprocesses with the ``LRT_*`` (or
torchrun's) environment, waits at most ``TIMEOUT_S`` for all of them, kills
every rank on a timeout, and runs gloo with a finite timeout of its own.

- ``python -m llava_reward_torch.dryrun step``: one tiny phi3v LoRA step
  (heads with SkipCA, decoder and vision LoRA, the projector; remat on) on
  2 ranks (fsdp 2) and 4 ranks (dp 2 x fsdp 2, and the zpg hybrid mesh)
  gives JAX's single-device ``make_train_step`` loss within PARITY.md's
  2.03e-05, its ``grad_norm`` within GRAD_RTOL and its updated trainable
  leaves within UPDATE_RTOL of the largest update (plus two fp32 ulps of
  the parameter, the rounding of p + update); also with
  ``--add_pretrain_loss`` at unequal valid-token counts per rank (its ptx
  term, ~1e3, within 2.03e-05 relative) and with
  ``max_norm`` clipping active. The rows' image-token counts differ, so a
  rank's own maximum is not the global one (SkipCA's zero-pad width). The
  optimizer runs at lr 1 and eps 1, where Adam's first update is
  g / (|g| + 1): the updated leaves then hold the gradients, not their signs.
  The ranks agree with each other exactly.
- The train CLI on 2 ranks (LLaVA, the fastest tiny family): the rows of the
  ranks partition the train rows, the losses equal a one-process run with
  twice the micro batch (the same rows a step), evaluation gathers every
  rank's pairs, the artifact is written once and equals the one-process
  one, and the 2-rank train-state checkpoint resumes in one process and the
  one-process checkpoint on 2 ranks.
- ``python -m llava_reward_torch.dryrun multichip 4 --device cpu`` exits 0
  with a finite loss for every family.

Every launched rank computes on one thread (``OMP_NUM_THREADS=1``), so that
a launch repeats itself bit for bit.

JAX twins: tests/test_multiprocess.py, test_train_and_sharding.py:199-232,
test_multifamily_sharding.py:106-190, test_preemption.py.
"""

import json
import math
import os
import socket
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llava_reward_tpu.core.config import RewardConfig as JRewardConfig
from llava_reward_tpu.core.config import phi3v_tiny_config
from llava_reward_tpu.lora import lora as jlora
from llava_reward_tpu.models import phi3v as jphi3v
from llava_reward_tpu.preprocess.phi3v_processor import build_img_gather_idx
from llava_reward_tpu.reward.model import RewardBatch as JBatch
from llava_reward_tpu.reward.model import init_head_params as j_init_head
from llava_reward_tpu.train import optim as joptim
from llava_reward_tpu.train import train_step as jts
from llava_reward_torch import train_llava_reward as t_train_cli
from llava_reward_torch.io.convert import to_torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PAIRS = os.path.join(ROOT, "data/sample_test/pairwise_sample.json")
TIMEOUT_S = 120
LOSS_TOL = 2.03e-05  # PARITY.md
GRAD_RTOL = 1e-4  # fp32 through two libraries (tests/test_torch_train_step.py)
UPDATE_RTOL = 1e-4  # of the largest element of each leaf's update
F32_EPS = float(np.finfo(np.float32).eps)
S = 352
N_IMG = 313  # 1x1 crop grid: (1+1)*144 + 1 + 2*12


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module", autouse=True)
def _one_thread_a_rank():
    """Each launched rank computes on one thread. On several, MKL's threaded
    fp32 GEMMs do not repeat themselves from launch to launch, and the
    ptx_unequal_tokens step, whose projector bias gradients cancel, then read
    0.085x to 2.5x its update bound; on one thread every launch gives the
    same bits, at 0.085x (MKL's reproducible mode, MKL_CBWR=COMPATIBLE, at
    four threads repeats itself too). Module-scoped, so that the ranks of
    the module's fixtures run so as well; the other gloo test files import
    it."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("OMP_NUM_THREADS", "1")
        yield


def _launch(n, argv, torchrun_env=False):
    """``n`` ranks of ``python argv`` -> each rank's stdout; every rank is
    killed if any is still running after TIMEOUT_S. The ranks find each
    other through the ``LRT_*`` variables, or torchrun's."""
    port = _free_port()
    procs = []
    for r in range(n):
        if torchrun_env:
            dist_env = dict(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port), WORLD_SIZE=str(n),
                            RANK=str(r), LOCAL_RANK=str(r), LOCAL_WORLD_SIZE=str(n))
        else:
            dist_env = dict(LRT_COORDINATOR=f"127.0.0.1:{port}", LRT_NUM_PROCESSES=str(n),
                            LRT_PROCESS_ID=str(r))
        e = dict(os.environ, PYTHONPATH=ROOT, **dist_env)
        procs.append(subprocess.Popen([sys.executable, *argv], cwd=ROOT, env=e, text=True,
                                      stdout=subprocess.PIPE, stderr=subprocess.PIPE))
    deadline, outs = time.monotonic() + TIMEOUT_S, []
    try:
        for p in procs:
            out, err = p.communicate(timeout=max(deadline - time.monotonic(), 1))
            assert p.returncode == 0, err[-3000:]
            outs.append(out)
    except subprocess.TimeoutExpired:
        pytest.fail(f"a rank of {argv} ran past {TIMEOUT_S} s")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return outs


# ---------------------------------------------------------------- one step


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _nonzero_b(tree, seed):
    rng = np.random.default_rng(seed)
    for t in tree.values():
        t["b"] = rng.standard_normal(t["b"].shape).astype(np.float32) * 0.05
    return tree


CFG = dict(num_crops=1)
RCFG = dict(is_general_preference=True, value_head_dim=2, add_cross_attention=True, layer_id=2)


@pytest.fixture(scope="module")
def trees():
    cfg = phi3v_tiny_config(**CFG)
    backbone = _np(jphi3v.init_params(jax.random.PRNGKey(0), cfg))
    rng = np.random.default_rng(6)
    backbone["lm_head"] = (rng.standard_normal((cfg.decoder.hidden_size,
                                                cfg.decoder.vocab_size)) * 0.02).astype(
        np.float32)
    trainable = {
        "head": _np(j_init_head(jax.random.PRNGKey(1), cfg, JRewardConfig(**RCFG))),
        "lora": _nonzero_b(_np(jlora.init_lora(jax.random.PRNGKey(2), cfg.decoder, 4, 8)), 3),
        "vision_lora": _nonzero_b(
            _np(jlora.init_vision_lora(jax.random.PRNGKey(4), cfg.vision, 4, 8)), 5),
        "projector": backbone["vision"]["img_projection"],
    }
    return cfg, {"backbone": backbone}, trainable


def _batch(cfg, seed, pads, n_imgs):
    """Four rows, each with its own left pad and image-token count."""
    rng = np.random.default_rng(seed)
    B = len(pads)
    gidx = build_img_gather_idx(1, 1, cfg.num_crops, budget=N_IMG)
    mask = np.ones((B, S), np.int32)
    splice = np.full((B, S), -1, np.int32)
    for b, (pad, n) in enumerate(zip(pads, n_imgs)):
        mask[b, :pad] = 0
        splice[b, pad + 1:pad + 1 + n] = np.arange(n)
    ids = rng.integers(2, cfg.decoder.vocab_size - 2, (B, S)).astype(np.int32)
    ids[mask == 0] = cfg.decoder.pad_token_id
    return {"input_ids": ids, "attention_mask": mask,
            "pixel_values": rng.uniform(-1, 1, (B, cfg.num_crops + 1, 336, 336, 3)).astype(
                np.float32),
            "img_gather_idx": np.tile(gidx[None], (B, 1)).astype(np.int32),
            "splice_idx": splice, "num_img_tokens": np.asarray(n_imgs, np.int32)}


CASES = {
    "fsdp2": dict(n=2, mesh={}),
    "dp2xfsdp2": dict(n=4, mesh={"mesh_dp": 2}),
    "hybrid_zpg2": dict(n=4, mesh={"zpg": 2}),
    "ptx_unequal_tokens": dict(n=2, mesh={}, loss={"add_pretrain_loss": True},
                               pads=(0, 3, 30, 38)),
    "max_norm": dict(n=2, mesh={}, optim={"max_norm": 1e-3}),
}


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


@pytest.mark.parametrize("case", list(CASES))
def test_ranks_take_the_jax_single_device_step(trees, case, tmp_path):
    c = CASES[case]
    cfg, frozen, trainable = trees
    pads = c.get("pads", (0, 21, 5, 0))
    chosen = _batch(cfg, 1, pads, (N_IMG, 200, 250, 150))
    rejected = _batch(cfg, 2, pads[::-1], (150, N_IMG, 200, 250))
    optim = dict(lr=1.0, total_steps=10, eps=1.0, warmup_ratio=0.0, **c.get("optim", {}))
    loss = dict(remat=True, **c.get("loss", {}))

    # JAX, one device, the whole batch
    jcfg, jr = phi3v_tiny_config(**CFG), JRewardConfig(**RCFG)
    jtx = joptim.make_optimizer(**optim)
    jfn = jts.make_pairwise_loss_fn(jcfg, jr, attn_impl="xla", **loss)
    jtrain = jax.tree_util.tree_map(jnp.asarray, trainable)
    js, jm = jax.jit(jts.make_train_step(jfn, jtx))(
        jts.init_train_state(jtrain, jtx), jax.tree_util.tree_map(jnp.asarray, frozen),
        JBatch(**{k: jnp.asarray(v) for k, v in chosen.items()}),
        JBatch(**{k: jnp.asarray(v) for k, v in rejected.items()}), None)

    spec = {"family": "phi3v", "cfg": CFG, "rcfg": RCFG, "mesh": c["mesh"], "optim": optim,
            "loss": loss, "frozen": to_torch(frozen, "cpu"),
            "trainable": to_torch(trainable, "cpu"),
            "chosen": {k: torch.from_numpy(v) for k, v in chosen.items()},
            "rejected": {k: torch.from_numpy(v) for k, v in rejected.items()}}
    torch.save(spec, tmp_path / "spec.pt")
    _launch(c["n"], ["-m", "llava_reward_torch.dryrun", "step", str(tmp_path / "spec.pt"),
                     str(tmp_path / "out.pt"), "--device", "cpu"])
    outs = [torch.load(tmp_path / f"out.pt.{r}", weights_only=True) for r in range(c["n"])]

    # the ranks agree exactly
    for o in outs[1:]:
        assert o["metrics"] == outs[0]["metrics"]
        for path, t in _paths(outs[0]["trainable"]):
            assert torch.equal(_get(o["trainable"], path), t), path
    m = outs[0]["metrics"]
    assert abs(m["preference_loss"] - float(jm["preference_loss"])) <= LOSS_TOL
    assert m["grad_norm"] == pytest.approx(float(jm["grad_norm"]), rel=GRAD_RTOL)
    if "add_pretrain_loss" in loss:
        # the ptx term is a sum of ~300 token log-probs a row (~1e3): relative
        for k in ("ptx_loss", "loss"):
            assert abs(m[k] - float(jm[k])) <= LOSS_TOL * max(1.0, abs(float(jm[k]))), k
    if "max_norm" in c.get("optim", {}):
        assert m["grad_norm"] > 10 * c["optim"]["max_norm"]  # the clip is active
    jnew = _np(js.trainable)
    for path, j in _paths(jnew):
        t = _get(outs[0]["trainable"], path).numpy()
        upd_j, upd_t = j - _get(trainable, path), t - _get(trainable, path)
        # plus the fp32 rounding of p + update (an update far below p's ulp)
        bound = UPDATE_RTOL * np.abs(upd_j).max() + 2 * F32_EPS * np.abs(j).max()
        assert np.abs(upd_t - upd_j).max() <= bound, "/".join(path)
    # the fsdp-sharded trainable leaves were held in blocks
    fsdp = c["n"] // (2 if c["mesh"] else 1)
    shapes = outs[0]["local_shapes"]
    assert shapes["lora/qkv_proj/a"][1] * fsdp == trainable["lora"]["qkv_proj"]["a"].shape[1]
    w_q = trainable["head"]["skipca"]["W_q"]["kernel"]
    assert shapes["head/skipca/W_q/kernel"][0] * fsdp == w_q.shape[0]
    # the trainable projector's path ("projector/...") matches no rule, in JAX neither
    assert shapes["projector/fc1/kernel"] == trainable["projector"]["fc1"]["kernel"].shape


# ---------------------------------------------------------------- the train CLI

CLI = ["--model_type", "llava", "--max_epochs", "1", "--seq_len", "2048",
       "--is_general_preference", "--value_head_dim", "2", "--lora_rank", "4",
       "--lora_alpha", "8", "--ft_projector", "--num_workers", "1", "--logging_steps", "1",
       "--train_split_ratio", "0.67", "--device", "cpu"]


def _summary(out):
    return json.loads(next(line for line in out.splitlines()
                           if line.startswith("train summary "))[len("train summary "):])


@pytest.fixture(scope="module")
def two_rank_cli(tmp_path_factory):
    d = tmp_path_factory.mktemp("cli2")
    rows = json.load(open(PAIRS))
    with open(d / "rows.json", "w") as f:
        json.dump(rows + rows[:2], f)  # six pairs: four train, two eval
    args = [*CLI, "--dataset", str(d / "rows.json")]
    outs = _launch(2, ["-m", "llava_reward_torch.train_llava_reward", *args,
                       "--micro_train_batch_size", "1", "--save_path", str(d / "save2"),
                       "--ckpt_path", str(d / "ckpt2")])
    one = t_train_cli.main([*args, "--micro_train_batch_size", "2",
                            "--save_path", str(d / "save1"), "--ckpt_path", str(d / "ckpt1")])
    return d, args, outs, one


def test_train_cli_ranks_partition_the_rows_and_match_one_process(two_rank_cli):
    d, _, outs, one = two_rank_cli
    s0, s1 = map(_summary, outs)
    assert (s0["world"], s1["world"], s0["backend"]) == (2, 2, "gloo")
    assert s0["mesh"] == {"dp": 1, "fsdp": 2, "tp": 1}
    assert set(s0["rows"]).isdisjoint(s1["rows"])
    assert sorted(s0["rows"] + s1["rows"]) == list(range(4))
    assert s0["steps"] == s1["steps"] == one.state.step == 2
    assert (s0["losses"], s0["grad_norms"]) == (s1["losses"], s1["grad_norms"])
    # the same two rows a step: each step's loss and norm as one process's
    for k, (loss, norm) in enumerate(zip(s0["losses"], s0["grad_norms"])):
        assert abs(loss - one.train_logs[k]["preference_loss"]) <= LOSS_TOL
        assert norm == pytest.approx(one.train_logs[k]["grad_norm"], rel=GRAD_RTOL)
    # each rank holds half of every sharded decoder projection
    single = sum(t.numel() * t.element_size() for _, t in
                 _paths(one.frozen["backbone"]["text"]["layers"]))
    assert single / 2 <= s0["layer_bytes"] == s1["layer_bytes"] < single


def test_train_cli_gathers_evaluation_and_writes_one_artifact(two_rank_cli):
    d, _, outs, one = two_rank_cli
    evals = [line for line in outs[0].splitlines() if "eval step" in line]
    assert evals and "'eval_num_pairs': 2.0" in evals[-1], evals  # one pair a rank, gathered
    assert not any("eval step" in line for line in outs[1].splitlines())  # rank 0 logs
    assert os.listdir(d / "save2") == ["epoch_0"]
    two = torch.load(d / "save2" / "epoch_0" / "pytorch_model.bin", weights_only=True)
    ref = torch.load(d / "save1" / "epoch_0" / "pytorch_model.bin", weights_only=True)
    assert two.keys() == ref.keys()
    for k in ref:
        torch.testing.assert_close(two[k], ref[k], rtol=0, atol=1e-5, msg=k)
    lora2 = torch.load(d / "save2" / "epoch_0" / "lora" / "adapter_model.bin",
                       weights_only=True)
    lora1 = torch.load(d / "save1" / "epoch_0" / "lora" / "adapter_model.bin",
                       weights_only=True)
    for k in lora1:
        torch.testing.assert_close(lora2[k], lora1[k], rtol=0, atol=1e-5, msg=k)


def test_two_rank_checkpoint_resumes_in_one_process(two_rank_cli):
    d, args, _, one = two_rank_cli
    state = torch.load(d / "ckpt2" / "train_state.pt", weights_only=True)
    resumed = t_train_cli.main([*args, "--micro_train_batch_size", "2", "--load_checkpoint",
                                "--save_path", str(d / "save_r"), "--ckpt_path",
                                str(d / "ckpt2")])
    assert resumed.state.step == 2  # both steps of the epoch were already taken
    for path, t in _paths(state["trainable"]):
        assert torch.equal(_get(resumed.state.trainable, path), t), path
        torch.testing.assert_close(_get(one.state.trainable, path), t, rtol=0, atol=1e-5)
    assert state["opt_state"]["count"] == 2


def test_one_process_checkpoint_resumes_on_two_ranks(two_rank_cli):
    """The reverse: the one-process run's checkpoint, read by 2 ranks, each
    keeping its blocks; the epoch's steps are already taken, so the artifact
    rank 0 writes from the gathered state is the one-process artifact."""
    d, args, _, _ = two_rank_cli
    outs = _launch(2, ["-m", "llava_reward_torch.train_llava_reward", *args,
                       "--micro_train_batch_size", "1", "--load_checkpoint",
                       "--save_path", str(d / "save_r2"), "--ckpt_path", str(d / "ckpt1")])
    assert [_summary(o)["steps"] for o in outs] == [2, 2]
    for name in ("pytorch_model.bin", "lora/adapter_model.bin"):
        got = torch.load(d / "save_r2" / "epoch_0" / name, weights_only=True)
        want = torch.load(d / "save1" / "epoch_0" / name, weights_only=True)
        assert got.keys() == want.keys()
        for k in want:
            assert torch.equal(got[k], want[k]), k


def test_dryrun_multichip_on_four_processes():
    outs = _launch(4, ["-m", "llava_reward_torch.dryrun", "multichip", "4", "--device",
                       "cpu"])
    for out in outs:
        lines = [line for line in out.splitlines() if line.startswith("dryrun[")]
        assert [line.split("]")[0] for line in lines] == [
            "dryrun[phi3v dp2xfsdp2", "dryrun[phi3v zpg hybrid dp2xfsdp2", "dryrun[qwen",
            "dryrun[llava"]
        for line in lines:
            assert math.isfinite(float(line.split("loss=")[1].split(",")[0]))
    assert len({o.split("dryrun_multichip")[1] for o in outs}) == 1  # the same on every rank
