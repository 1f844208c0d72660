"""No run may hold JAX or the JAX package: top-level module names compared
whole, so the port (whose name begins with the JAX package's) passes."""

import subprocess
import sys
import types

import pytest

from helpers import REPO, make_root

from benchmark.harness import common


@pytest.mark.parametrize("name,bad", [
    ("jax", True), ("jax.numpy", True), ("jaxlib.xla_client", True), ("flax.linen", True),
    ("llava_reward_tpu", True), ("llava_reward_tpu.core.config", True),
    ("llava_reward_torch", False), ("llava_reward_torch.models.phi3v", False),
    ("jaxtyping", False), ("flaxen", False), ("llava_reward_tpux", False),
])
def test_top_level_names_compared_whole(monkeypatch, name, bad):
    for k in [m for m in sys.modules if m.split(".")[0] in common.FORBIDDEN]:
        monkeypatch.delitem(sys.modules, k)
    monkeypatch.setitem(sys.modules, name, types.ModuleType(name))
    assert (common.forbidden_modules() != []) is bad


def test_a_run_holding_jax_prints_no_result(tmp_path, monkeypatch, capsys):
    root = make_root(str(tmp_path))
    sys.path.insert(0, f"{REPO}/benchmark")
    import run

    monkeypatch.setitem(sys.modules, "jax", types.ModuleType("jax"))
    rc = run.main(["--workload", "tiny.eval", "--seed", "3", "--seconds", "1", "--trace", "0",
                   "--device", "cpu", "--root", root])
    out, err = capsys.readouterr()
    assert rc != 0
    assert not out.strip().splitlines() or not out.strip().splitlines()[-1].startswith("{")
    assert "jax" in err


def test_the_load_process_and_the_references_import_no_torch_port_or_jax():
    code = ("import sys; import benchmark.harness.clients, benchmark.reference.phi3v, "
            "benchmark.reference.qwen; "
            "bad = sorted({m.split('.')[0] for m in sys.modules} & "
            "{'jax', 'jaxlib', 'flax', 'llava_reward_tpu', 'llava_reward_torch'}); "
            "print(bad); sys.exit(1 if bad else 0)")
    p = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                       timeout=120)
    assert p.returncode == 0, p.stdout + p.stderr
    code = "import sys, benchmark.harness.clients; sys.exit(1 if 'torch' in sys.modules else 0)"
    assert subprocess.run([sys.executable, "-c", code], cwd=REPO, timeout=120).returncode == 0
