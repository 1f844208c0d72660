"""A throwaway checkout for the CPU tests: BENCHMARK.json and the data files of
tiny cells under a temporary root, the harness's code and the metric readers
taken from this repository."""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(os.path.dirname(HERE))
sys.path.insert(0, REPO)

TINY_EVAL = {"image_sizes": [[64, 64], [96, 64]], "images_per_size": 2, "rows_per_second": 4,
             "checked_pairs": 3, "seq_len": 1024, "loader_workers": 2}
TINY_SERVE = {"image_sizes": [[64, 64], [96, 64], [64, 128]], "images_per_size": 2,
              "request_blocks": 6, "seq_len": 512, "clients": 3, "checked_requests": 3,
              "quantize_min_size": 0}


def make_root(tmp: str, limit: float = 2.2) -> str:
    """Two tiny cells, ``tiny.eval`` and ``tiny.serve``, in the layout of the
    real benchmark."""
    b = os.path.join(tmp, "benchmark")
    for d in ("configs", "traffic", "limits"):
        os.makedirs(os.path.join(b, d), exist_ok=True)
    shutil.copytree(os.path.join(REPO, "benchmark", "metrics"), os.path.join(b, "metrics"))
    for name in ("tiny_phi3v", "tiny_qwen"):
        shutil.copy(os.path.join(HERE, "data", f"{name}.json"), os.path.join(b, "configs"))
    for src, dst, extra in (("eval.bf16", "tiny_eval", TINY_EVAL),
                            ("serve.w8a8", "tiny_serve", TINY_SERVE)):
        with open(os.path.join(REPO, "benchmark", "traffic", f"{src}.json")) as f:
            t = dict(json.load(f), **extra)
        with open(os.path.join(b, "traffic", f"{dst}.json"), "w") as f:
            json.dump(t, f)
    with open(os.path.join(REPO, "BENCHMARK.json")) as f:
        bench = json.load(f)
    bench["configs"] = [{"name": n, "source": "tiny", "file": f"benchmark/configs/{n}.json",
                         "reduced": [], "why": "CPU test"} for n in ("tiny_phi3v", "tiny_qwen")]
    bench["workloads"] = [
        {"name": "tiny.eval", "config": "tiny_phi3v", "traffic": "tiny_eval", "chips": 1,
         "why": "CPU test"},
        {"name": "tiny.serve", "config": "tiny_qwen", "traffic": "tiny_serve", "chips": 1,
         "why": "CPU test"}]
    real = {"phi35v.eval.bf16": "tiny.eval", "qwen25vl7b.serve.w8a8": "tiny.serve"}
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m:
            m["workloads"] = [real.get(w, w) for w in m["workloads"]]
    write_bench(tmp, bench)
    for cell in ("tiny.eval", "tiny.serve"):
        with open(os.path.join(b, "limits", f"{cell}.json"), "w") as f:
            json.dump({"reward_gap_bf16_units": limit}, f)
    return tmp


def write_bench(root: str, bench: dict) -> None:
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)


def run_cell(root: str, cell: str, seed: int = 11, seconds: float = 2.0, trace: int = 0,
             env: dict = None):
    """``benchmark/run.py`` on the CPU: (exit code, stdout, stderr)."""
    e = dict(os.environ, OMP_NUM_THREADS="2", **(env or {}))
    p = subprocess.run([sys.executable, os.path.join(REPO, "benchmark", "run.py"),
                        "--workload", cell, "--seed", str(seed), "--seconds", str(seconds),
                        "--trace", str(trace), "--device", "cpu", "--root", root],
                       capture_output=True, text=True, timeout=600, env=e, cwd=REPO)
    return p.returncode, p.stdout, p.stderr


def last_json(stdout: str) -> dict:
    return json.loads(stdout.strip().splitlines()[-1])
