"""The traced window: ``torch.profiler`` over CPU and CUDA between ``start``
and ``stop``, reduced at once to what the per-layer metrics and the ledger
read (no chrome trace is written):

- ``busy_s``: the union of the kernel intervals on the device timeline;
- ``window_s``: host seconds from start to stop (stop synchronises);
- ``spans``: device seconds of the kernels inside the device-side range
  of each benchmark span's annotation (``spans.py``);
- ``nccl_s`` / ``nccl_alone_s``: NCCL kernels' seconds, and those with no
  other kernel running;
- ``device_ops`` and ``idle_gaps``: the ten device operations that took most
  time, and the ten longest idle gaps labelled by the host's innermost
  operation at the gap's middle.
"""

from __future__ import annotations

import bisect
import time
from typing import Dict, List, Tuple

import torch

from . import spans


def _is_device(e) -> bool:
    return str(e.device_type).split(".")[-1] in ("CUDA", "PrivateUse1")


def _union(iv: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[Tuple[float, float]] = []
    for a, b in sorted(iv):
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1] = (out[-1][0], b)
        else:
            out.append((a, b))
    return out


def _sync() -> None:
    if torch.cuda.is_available():
        torch.cuda.synchronize()


class Tracer:
    """``start`` and ``stop`` may run on the thread that drives the device;
    the events are reduced later, by ``finish``, outside the window.
    ``overhead_s`` is the host time spent starting and stopping."""

    def __init__(self, begin: float = 0.0, end: float = 0.0):
        self.begin, self.end = begin, end  # perf_counter marks of the traced part
        self.prof = None
        self.summary: Dict = {}
        self.t0 = 0.0
        self.window_s = 0.0
        self.overhead_s = 0.0

    def start(self) -> None:
        from torch.profiler import ProfilerActivity, profile

        t = time.perf_counter()
        _sync()
        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if torch.cuda.is_available()
                                         else [])
        self.prof = profile(activities=acts)
        self.prof.start()
        spans.ACTIVE = True
        self.t0 = time.perf_counter()
        self.overhead_s += self.t0 - t

    def stop(self) -> None:
        _sync()
        t = time.perf_counter()
        self.window_s = t - self.t0
        spans.ACTIVE = False
        self.prof.stop()
        self.overhead_s += time.perf_counter() - t

    def before_call(self) -> None:
        """From the thread that drives the device, before each call: opens the
        traced part at the first call after ``begin``."""
        if self.prof is None and not self.summary and not self.window_s \
                and time.perf_counter() >= self.begin:
            self.start()

    def after_call(self) -> None:
        """... and after it: closes the traced part at the first call that
        ends after ``end``."""
        if self.running and time.perf_counter() >= self.end:
            self.stop()

    @property
    def running(self) -> bool:
        return spans.ACTIVE and self.prof is not None

    def finish(self) -> Dict:
        if self.prof is not None:
            self.summary = summarize(self.prof, self.window_s)
            self.prof = None
        return self.summary


def summarize(prof, window_s: float) -> Dict:
    evs = list(prof.events())
    marks = [e for e in evs if _is_device(e) and e.name in spans.NAMES]
    dev = sorted((e for e in evs if _is_device(e) and e.name not in spans.NAMES),
                 key=lambda e: e.time_range.start)
    host = [e for e in evs if not _is_device(e) and not e.is_async]
    busy = _union([(e.time_range.start, e.time_range.end) for e in dev])
    busy_s = sum(b - a for a, b in busy) / 1e6

    # a span's device seconds: the kernels inside the device-side range of its
    # annotation (from its first kernel to its last), one stream at a time
    starts = [e.time_range.start for e in dev]
    span_s: Dict[str, float] = {}
    for m in marks:
        a, b = m.time_range.start, m.time_range.end
        i = bisect.bisect_left(starts, a)
        inside = []
        while i < len(dev) and dev[i].time_range.start <= b:
            if dev[i].time_range.end <= b + 1e-3:
                inside.append((dev[i].time_range.start, dev[i].time_range.end))
            i += 1
        span_s[m.name] = span_s.get(m.name, 0.0) + sum(y - x for x, y in _union(inside)) / 1e6

    nccl = _union([(e.time_range.start, e.time_range.end) for e in dev
                   if "nccl" in e.name.lower()])
    other = _union([(e.time_range.start, e.time_range.end) for e in dev
                    if "nccl" not in e.name.lower()])
    alone = 0.0
    for a, b in nccl:
        alone += (b - a) - sum(max(0.0, min(b, y) - max(a, x)) for x, y in other)
    by_name: Dict[str, float] = {}
    for e in dev:
        by_name[e.name] = by_name.get(e.name, 0.0) + (e.time_range.end - e.time_range.start) / 1e6
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]

    gaps = [(b0, a1) for (_, b0), (a1, _) in zip(busy, busy[1:])]
    gaps.sort(key=lambda g: g[0] - g[1])
    idle = []
    for a, b in gaps[:10]:
        mid = (a + b) / 2
        inner = [e for e in host if e.time_range.start <= mid <= e.time_range.end]
        label = (min(inner, key=lambda e: e.time_range.end - e.time_range.start).name
                 if inner else "no host operation")
        idle.append([label, (b - a) / 1e6])
    return {"busy_s": busy_s, "window_s": window_s, "spans": span_s, "kernels": len(dev),
            "nccl_s": sum(b - a for a, b in nccl) / 1e6, "nccl_alone_s": alone / 1e6,
            "device_ops": [[n, s] for n, s in top], "idle_gaps": idle}
