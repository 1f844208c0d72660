"""The port's command lines against the JAX package's, on the CPU:

- ``python -m llava_reward_torch.train_llava_reward`` in its smoke mode (no
  ``--pretrain``: the tiny config and the crc32 word tokenizer) on
  ``data/sample_test`` writes an artifact that the JAX ``load_reward_adaptor``
  reads, with the port's loader scoring the same batch within 2.03e-05
  (PARITY.md); the JAX train CLI's smoke artifact loads in the port the same
  way. phi3v (LoRA on DEFAULT_TARGETS, projector) and llava (LoRA on
  QWEN_TARGETS, ``multi_modal_projector``);
- ``python -m llava_reward_torch.eval_batch_inference`` on that artifact over a
  base checkpoint without tokenizer files (the hash-tokenizer fallback, its
  word hash pinned to crc32 in both CLIs so that the ids do not change with
  the process's hash seed; both CLIs run in this one process): the four
  sample pairs' rewards row by row within eight bf16 steps of the largest
  (both score in bf16), the same decisions beyond that gap, the mean
  probability within one step;
- the pointwise objective on ``data/Unsafebench`` rows (sniffed from the rows);
- ``--load_in_8bit`` and ``--load_in_4bit`` (nf4, absmax) train LoRA over
  a quantized frozen decoder and refuse full fine-tuning and each other, as
  the JAX CLI does;
- ``--mesh_tp`` above 1 over a quantized decoder refuses with ROADMAP A9, a
  mesh that does not match the world refuses as the JAX CLI's does, two
  ranks launched with torchrun's environment each train on their own rows
  over fsdp 2, or on the same rows over tp 2, and ``--device`` defaults to
  cuda, which raises on a machine without one.

JAX twins: tests/test_safety_pointwise_data.py (the pointwise train CLI),
tests/test_llava_adaptor.py and tests/test_artifact_io.py (artifacts).
"""

import json
import os
import sys
import zlib

import numpy as np
import pytest
import torch

import jax

import eval_batch_inference as j_eval_cli
import train_llava_reward as j_train_cli
from llava_reward_tpu.core.args import build_train_parser as j_train_parser
from llava_reward_tpu.core.config import llava_tiny_config, phi3v_tiny_config
from llava_reward_tpu.evalx import adaptor as jad
from llava_reward_tpu.io.hf_phi3v import hf_state_dict_from_params as j_phi3v_sd
from llava_reward_tpu.io.torch_io import save_torch_state_dict as j_save_sd
from llava_reward_tpu.models import llava_next as jllava
from llava_reward_tpu.models import phi3v as jphi3v
from llava_reward_torch import eval_batch_inference as t_eval_cli
from llava_reward_torch import train_llava_reward as t_train_cli
from llava_reward_torch.data.sampler import GroupSampler
from llava_reward_torch.evalx import adaptor as tad
from llava_reward_torch.utils import quantize as tquant
from test_llava_adaptor import _llava_hf_sd
from test_torch_llava import _config_json as _llava_config_json
from test_torch_llava import _pair_fields, _stacked
from test_torch_llava import _jb as _llava_jb
from test_torch_llava import _tb as _llava_tb
from test_torch_loading import _phi3v_config_json
from test_torch_multiprocess import _launch
from test_torch_reward import N_IMG, _batch, _jb, _tb

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PAIRS = os.path.join(ROOT, "data/sample_test/pairwise_sample.json")
UNSAFE = os.path.join(ROOT, "data/Unsafebench/Unsafebench_train.json")
PARITY_BAR = 2.03e-05
# both eval CLIs score in bf16 (their compute dtype): probabilities near 0.5
# agree to one bf16 step, 2**-8; rewards to eight such steps of the largest
# (the two round their bf16 activations at different points)
BF16_STEP = 2.0 ** -8
BF16_REWARD_TOL = 8 * BF16_STEP
SMOKE = ["--dataset", PAIRS, "--max_epochs", "1", "--micro_train_batch_size", "2",
         "--is_general_preference", "--value_head_dim", "2", "--lora_rank", "4",
         "--lora_alpha", "8", "--ft_projector", "--num_workers", "2"]
SEQ = {"phi3v": "1024", "llava": "2048"}


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, jax.device_get(tree))


@pytest.fixture(scope="module")
def bases(tmp_path_factory):
    """Base checkpoints (HF keys, config.json, no tokenizer files) of the
    smoke mode's tiny configs, from the JAX init."""
    root = tmp_path_factory.mktemp("bases")
    out = {}
    for name, cfg, init, to_sd, cj in (
            ("phi3v", phi3v_tiny_config(num_crops=4), jphi3v.init_params, j_phi3v_sd,
             _phi3v_config_json),
            ("llava", llava_tiny_config(), jllava.init_params, _llava_hf_sd,
             _llava_config_json)):
        d = root / name
        os.makedirs(d)
        params = _np(init(jax.random.PRNGKey(7), cfg))
        j_save_sd(to_sd(params, cfg), str(d / "pytorch_model.bin"), torch.float32)
        with open(d / "config.json", "w") as f:
            json.dump(cj(cfg), f)
        out[name] = str(d)
    return out


def _port_train(tmp, model_type, extra=()):
    t_train_cli.main(["--model_type", model_type, *SMOKE, "--seq_len", SEQ[model_type],
                      "--save_path", str(tmp / "save"), "--ckpt_path", str(tmp / "ckpt"),
                      "--device", "cpu", *extra])
    return str(tmp / "save" / "epoch_0")


def _score_both(base, pm, model_type, **kw):
    """Both packages' loaders on (base, pm) and their rewards on one batch."""
    ja = jad.load_reward_adaptor(base, pm, model_type=model_type, **kw)
    ta = tad.load_reward_adaptor(base, pm, model_type=model_type, device="cpu", **kw)
    if model_type == "phi3v":
        ja.rcfg.layer_id = ta.rcfg.layer_id = ja.cfg.decoder.num_layers
        fields = _batch(ja.cfg, [0, 25], [N_IMG, N_IMG - 40])
        jb, tb = _jb(fields), _tb(fields)
    else:
        ja.rcfg.layer_id = ta.rcfg.layer_id = ja.cfg.text.num_layers
        fields = _stacked([_pair_fields(ta.cfg, [(50, 900), (120, 700)], seed=2)])
        jb, tb = _llava_jb(fields), _llava_tb(fields)
    j = np.asarray(ja.make_score_fn()(ja.params, jb))
    t = ta.make_score_fn()(ta.params, tb).numpy()
    return j, t


@pytest.mark.parametrize("model_type", ["phi3v", "llava"])
def test_port_train_cli_artifact_loads_in_both_packages(model_type, bases, tmp_path):
    pm = _port_train(tmp_path, model_type)
    for f in ("pytorch_model.bin", "reward_config.yaml", "lora/adapter_config.json",
              "lora/adapter_model.bin"):
        assert os.path.exists(os.path.join(pm, f)), f
    with open(os.path.join(pm, "lora", "adapter_config.json")) as f:
        targets = set(json.load(f)["target_modules"])
    assert targets == set(tad.DEFAULT_TARGETS if model_type == "phi3v" else tad.QWEN_TARGETS)
    sd = torch.load(os.path.join(pm, "pytorch_model.bin"), weights_only=True)
    proj = "img_projection" if model_type == "phi3v" else "multi_modal_projector.linear_1"
    assert any(proj in k for k in sd), sorted(sd)
    assert os.path.exists(tmp_path / "ckpt" / "train_state.pt")
    j, t = _score_both(bases[model_type], pm, model_type)
    assert np.isfinite(t).all()
    np.testing.assert_allclose(t, j, rtol=0, atol=PARITY_BAR)


def test_jax_train_cli_artifact_loads_in_the_port(bases, tmp_path):
    """The JAX CLI shards its batch over the suite's eight virtual devices, so
    the four sample pairs make no full step: it writes its initial trainables
    (heads, LoRA, projector), which is the artifact's format all the same."""
    args = j_train_parser().parse_args(
        ["--model_type", "phi3v", *SMOKE, "--seq_len", SEQ["phi3v"],
         "--save_path", str(tmp_path / "save"), "--ckpt_path", str(tmp_path / "ckpt")])
    j_train_cli.train(args)
    pm = str(tmp_path / "save" / "epoch_0")
    j, t = _score_both(bases["phi3v"], pm, "phi3v")
    np.testing.assert_allclose(t, j, rtol=0, atol=PARITY_BAR)


@pytest.fixture(scope="module")
def phi3v_artifact(tmp_path_factory):
    return _port_train(tmp_path_factory.mktemp("artifact"), "phi3v")


def test_eval_cli_matches_the_jax_cli(bases, phi3v_artifact, monkeypatch, capsys):
    """The four sample pairs, one stacked call of eight rows (the loaded
    config's 16 crops, as the published one has: sequences of 2944): every
    row's reward from both CLIs, which score in bf16, within eight bf16 steps
    of the largest; the same decisions wherever that gap cannot flip them, and
    the mean probability within one bf16 step. (The accuracies are not
    compared: both take the probabilities in bf16, where the ties at 0.5
    depend on each package's rounding.)"""
    seen = {"jax": [], "torch": []}

    def recording(cls, name, to_np):
        make = cls.make_score_fn

        def make_score_fn(self, *a, **kw):
            fn = make(self, *a, **kw)

            def score(params, batch):
                r = fn(params, batch)
                seen[name].append(to_np(r))
                return r

            return score

        monkeypatch.setattr(cls, "make_score_fn", make_score_fn)

    # both smoke tokenizers look `hash` up in their module: a stable word hash
    # (the train CLIs' crc32) keeps the ids, and so the rewards, the same
    # under every PYTHONHASHSEED
    for mod in (j_eval_cli, t_eval_cli):
        monkeypatch.setattr(mod, "hash", lambda t: zlib.crc32(t.encode()), raising=False)
    recording(jad.RewardAdaptor, "jax", lambda r: np.asarray(r, np.float32))
    recording(tad.RewardAdaptor, "torch", lambda r: r.float().numpy())
    argv = ["--pretrain", bases["phi3v"], "--pm_path", phi3v_artifact, "--dataset", PAIRS,
            "--micro_batch_size", "4", "--seq_len", "2944", "--num_workers", "1"]
    tm = t_eval_cli.main([*argv, "--device", "cpu"])
    monkeypatch.setattr(sys, "argv", ["eval_batch_inference.py", *argv, "--attn_impl", "xla"])
    capsys.readouterr()
    j_eval_cli.main()
    out = capsys.readouterr().out
    assert "hash tokenizer" in out  # the base has no tokenizer files: the smoke fallback
    jm = json.loads(out[out.index("{"):])
    assert tm["num_pairs"] == jm["num_pairs"] == 4
    (j,), (t,) = seen["jax"], seen["torch"]
    assert j.shape == t.shape == (8, 2)
    tol = BF16_REWARD_TOL * np.abs(j).max()
    np.testing.assert_allclose(t, j, rtol=0, atol=tol)
    # the GPM decision, sign(c0 r1 - c1 r0), of every pair that a change of
    # each reward by up to tol cannot flip
    s_j = j[:4, 0] * j[4:, 1] - j[:4, 1] * j[4:, 0]
    s_t = t[:4, 0] * t[4:, 1] - t[:4, 1] * t[4:, 0]
    held = np.abs(s_j) > tol * (np.abs(j[:4]).sum(1) + np.abs(j[4:]).sum(1)) + 2 * tol ** 2
    assert held.sum() >= 2, (s_j, tol)
    assert ((s_j > 0) == (s_t > 0))[held].all(), (s_j, s_t)
    assert tm["mean_prob"] == pytest.approx(jm["mean_prob"], abs=BF16_STEP)


def test_pointwise_rows_train_the_cls_objective(tmp_path):
    """UnsafeBench rows (the reference's pointwise schema, extra keys and
    all) are sniffed as pointwise: the classification objective trains and
    its artifact lands."""
    _port_train(tmp_path, "phi3v", ["--dataset", UNSAFE, "--image_root",
                                    os.path.join(ROOT, "data"), "--max_samples", "6",
                                    "--train_split_ratio", "0.67"])
    pm = tmp_path / "save" / "epoch_0"
    assert os.path.exists(pm / "pytorch_model.bin")
    with open(pm / "reward_config.yaml") as f:
        assert "is_general_preference" in f.read()


@pytest.mark.parametrize("flags, exc, match", [
    (["--mesh_dp", "2"], ValueError, "mesh 2x-1x1: 1 devices"),
    (["--load_in_4bit", "--mesh_tp", "2"], ValueError,
     r"tp 2 leaves each rank \{'decoder o_proj in': 32\}.*64-row NF4 block")],
    ids=["mesh_dp_one_process", "mesh_tp"])
def test_unported_train_options_name_their_roadmap_item(flags, exc, match, tmp_path):
    """``--mesh_tp 2`` over the smoke config's NF4 decoder leaves each rank
    32 rows of o_proj, not whole 64-row NF4 blocks: ``check_tp`` refuses it
    with the widths named, before any process group starts (ROADMAP §C: the
    JAX package keeps 4-bit leaves whole on every rank). ``--mesh_dp 2`` in
    one process asks for a mesh that does not match the world, which
    ``create_mesh`` refuses, as the JAX one does."""
    with pytest.raises(exc, match=match):
        _port_train(tmp_path, "phi3v", flags)


@pytest.mark.parametrize("flags, key", [
    (["--load_in_8bit"], "qvalues_w8a8"), (["--load_in_4bit"], "qvalues_nf4"),
    (["--load_in_4bit", "--quant_scheme", "absmax"], "qvalues_i4")],
    ids=["8bit", "4bit_nf4", "4bit_absmax"])
def test_quantized_decoder_flags_train(flags, key, tmp_path, monkeypatch):
    """LoRA over a quantized frozen decoder: the smoke mode takes its step and
    writes an artifact of LoRA, heads and projector only. The CLI quantizes
    leaves of at least 1 M elements, as the JAX one does, which no leaf of
    the tiny config reaches: ``min_size`` 0 here, so that every projection is
    quantized."""
    q = tquant.quantize_stacked_layers
    monkeypatch.setattr(tquant, "quantize_stacked_layers",
                        lambda *a, **kw: q(*a, **{**kw, "min_size": 0}))
    trainer = t_train_cli.main(["--model_type", "phi3v", *SMOKE, "--seq_len", SEQ["phi3v"],
                                "--save_path", str(tmp_path / "save"),
                                "--ckpt_path", str(tmp_path / "ckpt"), "--device", "cpu", *flags])
    layers = trainer.frozen["backbone"]["decoder"]["layers"]
    for name in ("qkv_proj", "o_proj", "gate_up_proj", "down_proj"):
        assert key in layers[name], name
    assert trainer.state.step >= 1
    sd = torch.load(tmp_path / "save" / "epoch_0" / "pytorch_model.bin")
    assert sd and not any("qvalues" in k for k in sd)


@pytest.mark.parametrize("flags, match", [
    (["--lora_rank", "0", "--load_in_8bit"], "require LoRA"),
    (["--load_in_4bit", "--load_in_8bit"], "exclusive")], ids=["full_finetune", "both"])
def test_quantized_decoder_flags_refuse_as_the_jax_cli(flags, match, tmp_path):
    with pytest.raises(ValueError, match=match):
        _port_train(tmp_path, "phi3v", flags)


def test_more_than_one_process_names_a7(tmp_path):
    """WORLD_SIZE=2 (torchrun's environment, ROADMAP A7): each rank of the
    train CLI joins the group, reads its own rows through its sampler and
    trains on the mesh the flags give, here fsdp 2 (``--zero_stage 3``)."""
    outs = _launch(2, ["-m", "llava_reward_torch.train_llava_reward", *SMOKE,
                       "--model_type", "llava", "--seq_len", SEQ["llava"], "--zero_stage", "3",
                       "--micro_train_batch_size", "1", "--save_path", str(tmp_path / "save"),
                       "--ckpt_path", str(tmp_path / "ckpt"), "--device", "cpu"],
                   torchrun_env=True)
    s = [json.loads(out.split("train summary ")[1].splitlines()[0]) for out in outs]
    assert [x["rank"] for x in s] == [0, 1] and all(x["world"] == 2 for x in s)
    assert all(x["mesh"] == {"dp": 1, "fsdp": 2, "tp": 1} for x in s)
    n_train = len(set(s[0]["rows"] + s[1]["rows"]))
    for x in s:  # rank r's rows are GroupSampler(num_replicas=2, rank=r)'s
        assert x["rows"] == list(GroupSampler(n_train, num_replicas=2, rank=x["rank"],
                                              shuffle=True, seed=42))
    assert s[0]["losses"] == s[1]["losses"] and s[0]["steps"] == s[1]["steps"] >= 1


def test_two_tp_ranks_read_the_same_rows(tmp_path):
    """``--mesh_tp 2`` on 2 ranks (torchrun's environment): one data rank, so
    both ranks read every row (``GroupSampler(num_replicas=1)``), log the same
    losses, report the tp mesh, and rank 0 alone writes the artifact."""
    outs = _launch(2, ["-m", "llava_reward_torch.train_llava_reward", *SMOKE,
                       "--model_type", "llava", "--seq_len", SEQ["llava"], "--mesh_tp", "2",
                       "--micro_train_batch_size", "1", "--save_path", str(tmp_path / "save"),
                       "--ckpt_path", str(tmp_path / "ckpt"), "--device", "cpu"],
                   torchrun_env=True)
    s = [json.loads(out.split("train summary ")[1].splitlines()[0]) for out in outs]
    assert all(x["mesh"] == {"dp": 1, "fsdp": 1, "tp": 2} for x in s)
    n_train = len(s[0]["rows"])
    assert s[0]["rows"] == s[1]["rows"] == list(GroupSampler(n_train, num_replicas=1, rank=0,
                                                             shuffle=True, seed=42))
    assert s[0]["losses"] == s[1]["losses"] and s[0]["steps"] == s[1]["steps"] >= 1
    assert [out.count("saved reward artifact") for out in outs] == [1, 0]
    assert os.listdir(tmp_path / "save") == ["epoch_0"]


def test_device_defaults_to_cuda(bases, phi3v_artifact, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA; the default device is valid here")
    assert t_train_cli.build_parser().parse_args([]).device == "cuda"
    assert t_eval_cli.build_parser().parse_args(["--pm_path", "x", "--dataset", "y"]).device == \
        "cuda"
    with pytest.raises(RuntimeError, match="cuda"):
        t_train_cli.main(["--dataset", PAIRS, "--save_path", str(tmp_path / "s"),
                          "--ckpt_path", str(tmp_path / "c")])
    with pytest.raises(RuntimeError, match="cuda"):
        t_eval_cli.main(["--pretrain", bases["phi3v"], "--pm_path", phi3v_artifact,
                         "--dataset", PAIRS])


def test_wandb_stays_optional_and_gets_the_logs(tmp_path, monkeypatch):
    """--use_wandb imports wandb lazily: absent, the run goes on with a
    warning; present (a stand-in module here), it gets the run's config and
    the train and eval logs, and is finished."""
    import types

    calls = []
    fake = types.SimpleNamespace(init=lambda **kw: calls.append(("init", kw)),
                                 log=lambda d: calls.append(("log", d)),
                                 finish=lambda: calls.append(("finish", None)))
    monkeypatch.setitem(sys.modules, "wandb", fake)
    _port_train(tmp_path / "with", "phi3v", ["--use_wandb", "1", "--wandb_project", "p"])
    assert calls[0][0] == "init" and calls[0][1]["project"] == "p"
    logged = [d for kind, d in calls if kind == "log"]
    assert any("train/preference_loss" in d for d in logged)
    assert any("eval/eval_acc" in d for d in logged)
    assert calls[-1] == ("finish", None)
    monkeypatch.setitem(sys.modules, "wandb", None)  # import wandb raises ImportError
    _port_train(tmp_path / "without", "phi3v", ["--use_wandb", "1"])
    assert os.path.exists(tmp_path / "without" / "save" / "epoch_0" / "pytorch_model.bin")
