"""Tracing and profiling hooks (``llava_reward_tpu/utils/profiling.py``).

- ``trace(dir)``: a ``torch.profiler`` trace of the CPU, every thread of the
  process, and, where there is one, the card (CUDA activity), written to
  ``dir`` as a Chrome trace; the profile object is yielded, so
  ``key_averages()`` reads it afterwards. If the profiler cannot start,
  ``trace`` raises: a caller that asked for a trace never gets an untraced
  run in its place;
- the port's spans and counters: ``span(name, **attrs)`` times a block,
  ``record(name, start_ns, end_ns, **attrs)`` keeps an interval timed by the
  caller, ``count(name, n)`` adds to a counter. They record only while a
  ``torch.profiler`` runs anywhere in the process (``trace``, or any other
  profile started on any thread); with it off a span costs a global read and
  a branch. ``session()`` holds what the latest profiling session recorded:
  each profiler start opens a new one (importing this module wraps
  ``torch.autograd.profiler._run_on_profiler_start``). Records are stamped on the
  profiler's clock (``time.time_ns``: the scale of the profiler's
  ``trace_start_ns() + 1000 * time_range.start``), carry their thread, the
  span they ran inside and a request id, and are kept in memory, at most
  ``MAX_RECORDS`` a session. A span also opens a record function of its
  name, so a trace of its thread shows it as a host operation; it is of
  function scope, like an ATen operator's, and not a user annotation: the
  device trace gives it no device-side range, and an annotation around it
  (``record_function``) keeps the range of every kernel launched inside.
  A span inside one of its own name on the same thread records nothing
  (``attn`` and ``w8a8`` mark the outermost entry). ``NAMES`` lists every
  span and counter;
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
import functools
import itertools
import os
import threading
import time
from typing import Dict, List, NamedTuple, Optional

import torch
import torch.autograd.profiler as _autograd_profiler


class Name(NamedTuple):
    kind: str  # "span"; "interval" (timed by the caller, no record function); "counter"
    launches: bool  # may launch device work (a user annotation of it would get a device range)
    what: str


NAMES: Dict[str, Name] = {
    "serve.prep": Name("span", False, "request thread: template, image decode and processor "
                                      "for one request; attr images"),
    "serve.queue": Name("interval", False, "batcher: a request's wait, enqueue to the start of "
                                           "the last device call carrying one of its rows"),
    "serve.wait": Name("span", False, "batcher: from the end of one call to the start of the "
                                      "next, the blocked get and the coalescing window"),
    "serve.call": Name("span", True, "batcher: one device call; attrs rows, requests"),
    "serve.collate": Name("span", True, "batcher: collate at the call's shape, copy to the card"),
    "serve.step": Name("span", True, "batcher: the score function under the lock, to .cpu()"),
    "serve.rows": Name("counter", False, "batcher: real rows of the device calls"),
    "serve.pad_rows": Name("counter", False, "batcher: padding rows of the device calls (none: "
                                             "a call computes its rows alone)"),
    "serve.calls": Name("counter", False, "batcher: device calls"),
    "serve.tokens": Name("counter", False, "batcher: valid tokens of the device calls' rows"),
    "serve.tokens_padded": Name("counter", False, "batcher: tokens the device calls compute, "
                                                  "rows x padded length"),
    "serve.patches": Name("counter", False, "batcher: image patches of the device calls' rows "
                                            "(nonzero segment id)"),
    "serve.patches_padded": Name("counter", False, "batcher: patches the device calls compute, "
                                                   "rows x padded patches"),
    "norm.kernel_rows": Name("counter", False, "ops/norms: rows of card tensors normalised "
                                               "by the norm kernel"),
    "norm.plain_rows": Name("counter", False, "ops/norms: rows of card tensors normalised by "
                                              "the plain code (fp32, autograd, a row the "
                                              "kernel does not take)"),
    "loader.wait": Name("span", False, "consumer: blocked on the next finished batch"),
    "loader.decode_wait": Name("span", False, "producer: waiting on a batch's items"),
    "loader.collate": Name("span", False, "producer: a batch's collate"),
    "loader.device_put": Name("span", True, "producer: a batch's copy to the card"),
    "eval.step": Name("span", True, "consumer: stack the pair, score, preference, fetch"),
    "attn": Name("span", True, "caller: the outermost attention entry"),
    "w8a8": Name("span", True, "caller: an activation-quantizing epilogue or the int8 GEMM"),
}

MAX_RECORDS = 1 << 18


class Record(NamedTuple):
    id: int
    name: str
    start_ns: int
    end_ns: int
    thread: int  # native thread id
    parent: Optional[int]  # id of the span it ran inside, on its thread
    request: Optional[int]
    attrs: dict

    @property
    def seconds(self) -> float:
        return (self.end_ns - self.start_ns) / 1e9


class Session:
    """What one profiling session recorded."""

    def __init__(self, limit: int = MAX_RECORDS):
        self.records: List[Record] = []
        self.counts: Dict[str, int] = {}
        self.dropped = 0
        self.limit = limit
        self._lock = threading.Lock()

    def add(self, rec: Record) -> None:
        with self._lock:
            if len(self.records) < self.limit:
                self.records.append(rec)
            else:
                self.dropped += 1

    def count(self, name: str, n: int) -> None:
        with self._lock:
            self.counts[name] = self.counts.get(name, 0) + n

    def named(self, name: str) -> List[Record]:
        return [r for r in self.records if r.name == name]


_session = Session()
_ids = itertools.count(1)
_local = threading.local()  # .open: [(id, name), ...] of this thread's open spans


def session() -> Session:
    """The latest profiling session's records and counters."""
    return _session


def _open_session() -> None:
    global _session
    _session = Session()


def _hook_profiler_start() -> None:
    """Open a new session at each profiler start, before it reads as on."""
    start = _autograd_profiler._run_on_profiler_start
    if getattr(start, "opens_session", False):
        return

    def on_start():
        _open_session()
        start()

    on_start.opens_session = True
    _autograd_profiler._run_on_profiler_start = on_start


_hook_profiler_start()


def recording() -> bool:
    return _autograd_profiler._is_profiler_enabled


now = time.time_ns  # the profiler's clock


class _Span:
    __slots__ = ("name", "attrs", "session", "id", "parent", "start", "rf", "nested")

    def __init__(self, name: str, attrs: dict):
        if name not in NAMES:
            raise KeyError(f"span {name!r} is not in profiling.NAMES")
        self.name, self.attrs, self.session = name, attrs, _session

    def __enter__(self):
        stack = getattr(_local, "open", None)
        if stack is None:
            stack = _local.open = []
        self.nested = any(n == self.name for _, n in stack)
        if self.nested:
            return self
        self.id = next(_ids)
        self.parent = stack[-1][0] if stack else None
        stack.append((self.id, self.name))
        self.rf = torch._C._profiler._RecordFunctionFast(self.name)
        self.rf.__enter__()
        self.start = time.time_ns()
        return self

    def __exit__(self, *exc):
        if self.nested:
            return
        end = time.time_ns()
        self.rf.__exit__(*exc)
        _local.open.pop()
        req = self.attrs.pop("request", None)
        self.session.add(Record(self.id, self.name, self.start, end, threading.get_native_id(),
                                self.parent, req, self.attrs))


_OFF = contextlib.nullcontext()


def span(name: str, **attrs):
    """Time the block as ``name`` while a profiler runs; ``request`` in
    ``attrs`` is kept as the record's request id."""
    if not _autograd_profiler._is_profiler_enabled:
        return _OFF
    return _Span(name, attrs)


def spanned(name: str):
    """Decorate a function: each call is a ``span(name)``."""

    def wrap(fn):
        @functools.wraps(fn)
        def inner(*args, **kwargs):
            if not _autograd_profiler._is_profiler_enabled:
                return fn(*args, **kwargs)
            with _Span(name, {}):
                return fn(*args, **kwargs)

        return inner

    return wrap


def record(name: str, start_ns: int, end_ns: int, request: Optional[int] = None,
           **attrs) -> None:
    """Keep an interval the caller timed on ``now()`` (no record_function)."""
    if not _autograd_profiler._is_profiler_enabled:
        return
    if name not in NAMES:
        raise KeyError(f"interval {name!r} is not in profiling.NAMES")
    _session.add(Record(next(_ids), name, start_ns, end_ns, threading.get_native_id(), None,
                        request, attrs))


def count(name: str, n: int = 1) -> None:
    if not _autograd_profiler._is_profiler_enabled:
        return
    if name not in NAMES:
        raise KeyError(f"counter {name!r} is not in profiling.NAMES")
    _session.count(name, n)


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the block on every thread; the trace lands in
    ``log_dir/trace.json``."""
    from torch._C._profiler import _ExperimentalConfig
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    prof = profile(activities=activities, record_shapes=True,
                   experimental_config=_ExperimentalConfig(profile_all_threads=True))
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
    from ..ops import flash_attention, int8_matmul, norms, quant_epilogue

    return {**flash_attention.LAUNCHES, **quant_epilogue.LAUNCHES,
            **quant_epilogue.TP_LAUNCHES, **int8_matmul.LAUNCHES, **norms.LAUNCHES}


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
