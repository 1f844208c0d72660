"""What every run shares: the environment set before the port is imported,
the device checks, the files a cell is made of, the per-layer metrics (their
readers, spans and counters), the check that no JAX module was loaded, and
the result line."""

from __future__ import annotations

import importlib.util
import json
import os
import subprocess
import sys
from typing import Dict, List, Optional

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
BENCH = os.path.join(ROOT, "benchmark")
FORBIDDEN = ("jax", "jaxlib", "flax", "llava_reward_tpu")


def set_environment() -> None:
    """Fixed cache directories inside the checkout (the port's nvcc build is
    ``build/torch_kernels``, fixed by the port), and no JAX from libraries
    that would load it by themselves."""
    cache = os.path.join(BENCH, ".cache")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(cache, "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(cache, "triton")
    for k in ("USE_FLAX", "USE_JAX", "USE_TF"):
        os.environ[k] = "0"
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)


def load_benchmark(root: str = ROOT) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def load_json(kind: str, name: str, root: str = ROOT) -> dict:
    with open(os.path.join(root, "benchmark", kind, f"{name}.json")) as f:
        return json.load(f)


def forbidden_modules() -> List[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def device_or_exit(chips: int) -> None:
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"benchmark: this cell needs {chips} CUDA device(s), found {n}", file=sys.stderr)
        sys.exit(3)


def power_line() -> str:
    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              timeout=20).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "nvidia-smi: not available"


def device_info(device: str, chips: int, peak_bytes: int) -> dict:
    """The result's ``device``: the card's name, or the CPU of a test run."""
    if device != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": 0}
    import torch

    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": chips,
            "memory_peak_bytes": int(peak_bytes)}


def metrics_for(bench: dict, cell: str, kind: str) -> List[dict]:
    """The cell's end-to-end (``kind`` 'end_to_end') or per-layer metrics:
    those that list it, and those without a list whose ``moves`` metric the
    cell reports."""
    e2e = {m["name"] for m in metrics_for_e2e(bench, cell)}
    if kind == "end_to_end":
        return metrics_for_e2e(bench, cell)
    return [m for m in bench["per_layer"]
            if cell in m.get("workloads", [cell] if m["moves"] in e2e else [])]


def metrics_for_e2e(bench: dict, cell: str) -> List[dict]:
    return [m for m in bench["end_to_end"] if cell in m.get("workloads", [cell])]


def load_metric(name: str, root: str = ROOT):
    """``benchmark/metrics/<name>.py``: its ``read(data)``, and optionally its
    ``SPANS`` (span name -> the port's (module, attribute) entries it wraps)
    and ``count(work)`` (its counter over one device call's ``flops.Work``)."""
    path = os.path.join(root, "benchmark", "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"bench_metric_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def metric_spans(mods) -> Dict[str, list]:
    """The spans the metrics name, their entries merged by span name."""
    out: Dict[str, list] = {}
    for mod in mods:
        for name, entries in getattr(mod, "SPANS", {}).items():
            out.setdefault(name, [])
            out[name] += [tuple(e) for e in entries if tuple(e) not in out[name]]
    return out


def read_layer_metric(mod, data: Optional[dict]) -> Optional[float]:
    """The metric's ``read``: a number, or None when what it reads is not
    there. A metric with a ``count`` reads it summed over the window's
    device calls (``data['count']['window']``) and over the traced ones
    (``['traced']``)."""
    if data is not None and hasattr(mod, "count") and data.get("calls") is not None:
        c = [float(mod.count(w)) for w in data["calls"]]
        data = dict(data, count={"window": sum(c),
                                 "traced": sum(x for x, t in zip(c, data["traced"]) if t)})
    v = mod.read(data)
    return None if v is None else float(v)


def emit(correct: bool, attempted: int, failed: int, metrics: Dict[str, dict], device: dict,
         checks: Dict[str, dict], breakdown: Optional[dict] = None,
         readings: Optional[Dict[str, float]] = None) -> None:
    """The comparison's other readings, then the compared numbers beside
    their limits on standard error as its last lines, then the result as the
    last line of standard output, ``checks`` its last key."""
    for name, v in (readings or {}).items():
        if name not in checks:
            print(f"reading {name}: {v!r}", file=sys.stderr)
    for name, c in checks.items():
        print(f"check {name}: {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    out = {"correct": bool(correct), "attempted": int(attempted), "failed": int(failed),
           "metrics": metrics, "device": device}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["checks"] = checks
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
