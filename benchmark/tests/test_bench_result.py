"""A run's last line: the keys the contract names, the metrics of the cell's
kind, each compared number beside its limit, last on standard error and
last in the line."""

import pytest

from helpers import last_json, make_root, run_cell

from benchmark.harness import common

KEYS = ["correct", "attempted", "failed", "metrics", "device"]


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return make_root(str(tmp_path_factory.mktemp("bench")))


@pytest.mark.parametrize("cell", ["tiny.eval", "tiny.serve"])
@pytest.mark.parametrize("trace", [0, 1])
def test_last_line(root, cell, trace):
    rc, out, err = run_cell(root, cell, seed=2 ** 31 + 5, trace=trace)
    assert rc == 0, err[-3000:]
    line = last_json(out)
    want = KEYS + (["breakdown"] if trace else []) + ["checks"]
    assert list(line) == want
    assert line["correct"] is True and line["failed"] == 0 and line["attempted"] > 0
    bench = common.load_benchmark(root)
    kind = "per_layer" if trace else "end_to_end"
    names = {m["name"] for m in common.metrics_for(bench, cell, kind)}
    assert set(line["metrics"]) <= names
    if not trace:
        assert set(line["metrics"]) == names
        assert all(m["value"] > 0 for m in line["metrics"].values() if m["unit"] != "GiB")
    else:
        assert {"busy_s", "window_s"} <= set(line["device"])
        assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    for m in line["metrics"].values():
        assert set(m) == {"value", "unit"}
    tail = err.strip().splitlines()[-len(line["checks"]):]
    assert [t.split(":")[0] for t in tail] == [f"check {k}" for k in line["checks"]]
    for c in line["checks"].values():
        assert set(c) == {"value", "limit"}


def test_unknown_cell_prints_no_result(root):
    rc, out, _ = run_cell(root, "no.such.cell")
    assert rc != 0 and not out.strip()


def test_a_checkout_without_the_port_prints_no_result(tmp_path):
    """A directory holding only BENCHMARK.json and the benchmark's files."""
    import shutil
    import subprocess
    import sys

    from helpers import REPO

    shutil.copytree(f"{REPO}/benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", ".cache", "tests"))
    shutil.copy(f"{REPO}/BENCHMARK.json", tmp_path)
    p = subprocess.run([sys.executable, "benchmark/run.py", "--workload", "phi35v.eval.bf16",
                        "--seed", "1", "--seconds", "1", "--trace", "0", "--device", "cpu"],
                       cwd=tmp_path, capture_output=True, text=True, timeout=300)
    assert p.returncode != 0
    assert not p.stdout.strip()
