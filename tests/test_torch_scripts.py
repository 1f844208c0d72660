"""The port's launch scripts, ``scripts/torch/*.sh``, against their JAX twins
of the same name in ``scripts/``.

Each script is run by bash with a stub ``python`` first on ``PATH``, which
writes its argv as JSON instead of running anything. The port's command
line then:
- starts the port's entry point: the train CLI through
  ``torch.distributed.run`` (one process a host by default), the eval CLI,
  or ``evalx.simple_inference``;
- is accepted by that entry point's own parser;
- passes the JAX twin's flags, in the same order with the same values, and
  the caller's extra arguments after them (``"$@"``); the phi train script
  with ``CLS=0`` and ``CLS=1``.
Every script passes ``bash -n``, and none names the JAX package.
"""

import json
import os
import subprocess
import sys

import pytest

from llava_reward_torch import eval_batch_inference as t_eval_cli
from llava_reward_torch import train_llava_reward as t_train_cli
from llava_reward_torch.evalx import simple_inference as t_simple

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_DIR = os.path.join(ROOT, "scripts")
PORT_DIR = os.path.join(JAX_DIR, "torch")
TRAIN = ["run_train_rm_single_lora_phi.sh", "run_train_rm_single_lora_qwen.sh",
         "run_train_rm_single_lora_llava.sh", "run_train_rm_single_lora_ft.sh"]
EVAL = ["batch_inference_rm_phi.sh", "batch_inference_rm_ft_phi.sh",
        "batch_inference_rm_qwen.sh", "batch_inference_rm_llava.sh"]
USER_INPUT = "batch_inference_rm_phi_user_input.sh"
SCRIPTS = TRAIN + EVAL + [USER_INPUT]
TORCHRUN = ["-m", "torch.distributed.run", "--standalone", "--nproc_per_node", "1"]
# the port's entry point and parser, and the JAX twin's entry point, by script
ENTRY = {
    **{s: (TORCHRUN + ["-m", "llava_reward_torch.train_llava_reward"],
           t_train_cli.build_parser, ["train_llava_reward.py"]) for s in TRAIN},
    **{s: (["-m", "llava_reward_torch.eval_batch_inference"], t_eval_cli.build_parser,
           ["eval_batch_inference.py"]) for s in EVAL},
    USER_INPUT: (["-m", "llava_reward_torch.evalx.simple_inference"], t_simple.build_parser,
                 ["-m", "llava_reward_tpu.evalx.simple_inference"]),
}
CASES = [(s, {}) for s in SCRIPTS] + [("run_train_rm_single_lora_phi.sh", {"CLS": "1"})]
EXTRA = ["--logging_steps", "3"]  # passed through "$@" to a train script
EXTRA_EVAL = ["--seq_len", "1024"]  # ... and to an eval script


@pytest.fixture(scope="module")
def stub_bin(tmp_path_factory):
    """A directory whose ``python`` appends its argv as a JSON line to
    ``$STUB_OUT``."""
    d = tmp_path_factory.mktemp("stub_bin")
    stub = d / "python"
    stub.write_text(f"#!{sys.executable}\nimport json, os, sys\n"
                    "with open(os.environ['STUB_OUT'], 'a') as f:\n"
                    "    f.write(json.dumps(sys.argv[1:]) + '\\n')\n")
    stub.chmod(0o755)
    return d


def _argv(script, stub_bin, tmp_path, env=None, extra=()):
    """The argv ``script`` hands to ``python``, run from the repo's root."""
    out = tmp_path / (os.path.basename(script) + ".json")
    out.unlink(missing_ok=True)
    e = {k: v for k, v in os.environ.items() if k not in ("PYTHON", "CLS", "NPROC")}
    e.update(PATH=f"{stub_bin}{os.pathsep}{e.get('PATH', '')}", STUB_OUT=str(out),
             PM_PATH="ckpt/some_artifact", **(env or {}))
    r = subprocess.run(["bash", script, *extra], cwd=ROOT, env=e, text=True,
                       capture_output=True, timeout=60)
    assert r.returncode == 0, r.stderr
    lines = out.read_text().splitlines()
    assert len(lines) == 1, lines  # one python command a script
    return json.loads(lines[0])


def test_every_jax_script_has_a_port_twin():
    jax_scripts = sorted(f for f in os.listdir(JAX_DIR) if f.endswith(".sh"))
    assert sorted(os.listdir(PORT_DIR)) == jax_scripts == sorted(SCRIPTS)


@pytest.mark.parametrize("script", SCRIPTS)
def test_port_script_passes_bash_n(script):
    path = os.path.join(PORT_DIR, script)
    r = subprocess.run(["bash", "-n", path], capture_output=True, text=True, timeout=30)
    assert r.returncode == 0, r.stderr
    assert os.access(path, os.X_OK)


@pytest.mark.parametrize("script", SCRIPTS)
def test_port_script_names_no_jax_entry_point(script):
    text = open(os.path.join(PORT_DIR, script)).read()
    assert "llava_reward_tpu" not in text
    assert "train_llava_reward.py" not in text and "eval_batch_inference.py" not in text


@pytest.mark.parametrize("script, env", CASES,
                         ids=[s[:-3] + ("_cls" if e else "") for s, e in CASES])
def test_port_script_parses_and_passes_its_jax_twins_flags(script, env, stub_bin, tmp_path):
    entry, parser, jax_entry = ENTRY[script]
    extra = EXTRA_EVAL if script in EVAL or script == USER_INPUT else EXTRA
    port = _argv(os.path.join(PORT_DIR, script), stub_bin, tmp_path, env, extra)
    twin = _argv(os.path.join(JAX_DIR, script), stub_bin, tmp_path, env, extra)
    assert port[:len(entry)] == entry
    assert twin[:len(jax_entry)] == jax_entry
    flags, jax_flags = port[len(entry):], twin[len(jax_entry):]
    assert flags == jax_flags
    assert flags[-len(extra):] == list(extra)  # "$@" comes last
    args = parser().parse_args(flags)  # argparse exits on a flag it does not take
    if script in TRAIN:
        cls = env.get("CLS") == "1"
        assert (args.cls_based, args.is_general_preference) == (cls, not cls)
        assert args.value_head_dim == (1 if cls else 2)
    else:
        assert args.pm_path == "ckpt/some_artifact"


def test_train_scripts_take_nproc_and_the_interpreter(stub_bin, tmp_path):
    port = _argv(os.path.join(PORT_DIR, TRAIN[0]), stub_bin, tmp_path, {"NPROC": "4"})
    assert port[:5] == ["-m", "torch.distributed.run", "--standalone", "--nproc_per_node", "4"]
    alt = tmp_path / "py3"  # another interpreter: it marks its argv
    alt.write_text((stub_bin / "python").read_text().replace("sys.argv[1:]",
                                                             "['py3'] + sys.argv[1:]"))
    alt.chmod(0o755)
    port = _argv(os.path.join(PORT_DIR, USER_INPUT), stub_bin, tmp_path,
                 {"PYTHON": str(alt), "CAPTION": "two dogs"})
    assert port[:3] == ["py3", "-m", "llava_reward_torch.evalx.simple_inference"]
    assert port[port.index("--caption") + 1] == "two dogs"


def test_eval_script_without_pm_path_stops_before_python(stub_bin, tmp_path):
    e = {k: v for k, v in os.environ.items() if k != "PM_PATH"}
    e.update(PATH=f"{stub_bin}{os.pathsep}{e.get('PATH', '')}",
             STUB_OUT=str(tmp_path / "none.json"))
    r = subprocess.run(["bash", os.path.join(PORT_DIR, EVAL[0])], cwd=ROOT, env=e, text=True,
                       capture_output=True, timeout=30)
    assert r.returncode != 0 and "set PM_PATH" in r.stderr
    assert not (tmp_path / "none.json").exists()
