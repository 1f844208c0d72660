"""Tracing and profiling hooks (``llava_reward_tpu/utils/profiling.py``).

- ``trace(dir)``: a ``torch.profiler`` trace of the CPU and, where there is
  one, the card (CUDA activity), written to ``dir`` as a Chrome trace; the
  profile object is yielded, so ``key_averages()`` reads it afterwards. If
  the profiler cannot start, ``trace`` raises: a caller that asked for a
  trace never gets an untraced run in its place;
- ``annotate(name)``: a named region (``torch.profiler.record_function``);
- ``StepTimer``: per-step host-clock stats with a warmup skip; end the work
  inside the block with a synchronise (or a fetch to the host) for a true
  barrier;
- ``device_memory_stats()``: bytes in use, peak and the card's total from
  ``torch.cuda.memory_stats``, or None without a card;
- ``kernel_launches()``: every hand-written kernel's launch count in this
  process (each wrapper adds one where it launches its kernel); the command
  lines print it, so a caller sees which kernels a run went through;
  ``plain_calls()`` counts the plain versions' calls the same way, and
  ``kernel_shapes()`` the W8A8 launches by width and weight shape.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Dict, List, Optional

import torch


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the block; the trace lands in ``log_dir/trace.json``."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    prof = profile(activities=activities, record_shapes=True)
    try:
        prof.__enter__()
    except Exception as e:
        raise RuntimeError(f"torch.profiler could not start ({e}); refusing to run untraced") \
            from e
    try:
        yield prof
    finally:
        prof.__exit__(None, None, None)
        prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def annotate(name: str):
    return torch.profiler.record_function(name)


class StepTimer:
    """Per-step host-clock stats; skips the first ``warmup`` steps.

    with timer.step():  # end the work with a synchronise inside the block
        out = fn(...); torch.cuda.synchronize()
    """

    def __init__(self, warmup: int = 1):
        self.warmup = warmup
        self.times: List[float] = []
        self._seen = 0

    @contextlib.contextmanager
    def step(self):
        t0 = time.perf_counter()
        yield
        dt = time.perf_counter() - t0
        self._seen += 1
        if self._seen > self.warmup:
            self.times.append(dt)

    def stats(self) -> Dict[str, float]:
        import numpy as np

        if not self.times:
            return {"steps": 0}
        a = np.asarray(self.times)
        return {
            "steps": len(a),
            "mean_s": float(a.mean()),
            "median_s": float(np.median(a)),
            "p95_s": float(np.percentile(a, 95)),
            "min_s": float(a.min()),
        }


def device_memory_stats(device=None) -> Optional[Dict[str, int]]:
    if not torch.cuda.is_available():
        return None
    stats = torch.cuda.memory_stats(device)
    return {
        "bytes_in_use": int(stats.get("allocated_bytes.all.current", 0)),
        "peak_bytes_in_use": int(stats.get("allocated_bytes.all.peak", 0)),
        "bytes_limit": int(torch.cuda.get_device_properties(device or 0).total_memory),
    }


def kernel_launches() -> Dict[str, int]:
    from ..ops import flash_attention, int8_matmul, quant_epilogue

    return {**flash_attention.LAUNCHES, **quant_epilogue.LAUNCHES,
            **quant_epilogue.TP_LAUNCHES, **int8_matmul.LAUNCHES}


def kernel_shapes() -> Dict[str, int]:
    """B5's, B6's and the int8 GEMM's launches in this process by row width
    and weight shape (a tp rank's K / tp, N / tp)."""
    from ..ops import int8_matmul, quant_epilogue

    return {**quant_epilogue.SHAPES, **int8_matmul.SHAPES}


def plain_calls() -> Dict[str, int]:
    """The plain versions' calls in this process, by kernel (the route a run
    on the CPU took)."""
    from ..ops import flash_attention, int8_matmul, quant_epilogue

    return {**flash_attention.PLAIN_CALLS, **quant_epilogue.PLAIN_CALLS,
            **quant_epilogue.TP_PLAIN_CALLS, **int8_matmul.PLAIN_CALLS}
