"""The port's recorder (``llava_reward_torch/utils/profiling.py``) on the CPU:
spans, intervals and counters record only while a ``torch.profiler`` runs,
from any thread, into the latest session; a span lies on the profiler's
clock beside its record function, a host operation of function scope; parents,
request ids, and no span inside one of its own name; the table of names covers
every name the package uses. The service's and the loader's spans:
tests/test_torch_serving.py.
"""

import os
import re
import sys
import threading
import time

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from llava_reward_torch.ops import attention, quant_epilogue
from llava_reward_torch.utils import profiling

PKG = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                   "llava_reward_torch")


def _profile():
    return profile(activities=[ProfilerActivity.CPU])


def test_nothing_is_recorded_with_the_profiler_off():
    with _profile():
        with profiling.span("serve.step"):
            pass
    before = profiling.session()
    with profiling.span("serve.call", rows=2):
        profiling.count("serve.rows", 2)
        profiling.record("serve.queue", profiling.now(), profiling.now(), request=1)
    assert profiling.session() is before
    assert [r.name for r in before.records] == ["serve.step"] and before.counts == {}
    assert not profiling.recording()


def test_spans_from_a_second_thread_while_the_first_profiles():
    def other():
        with profiling.span("serve.prep", request=5, images=2):
            time.sleep(0.001)
        profiling.count("serve.calls")

    with _profile():
        th = threading.Thread(target=other)
        th.start()
        th.join(timeout=30)
    assert not th.is_alive()
    (r,) = profiling.session().named("serve.prep")
    assert r.thread == th.native_id != threading.get_native_id()
    assert r.request == 5 and r.attrs == {"images": 2} and r.seconds >= 0.001
    assert profiling.session().counts == {"serve.calls": 1}


def test_a_second_session_replaces_the_first():
    with _profile():
        with profiling.span("loader.wait"):
            pass
        profiling.count("serve.rows", 3)
    first = profiling.session()
    with _profile():  # no span in between: the profiler's start opens the session
        with profiling.span("eval.step"):
            pass
        profiling.count("serve.rows", 4)
    second = profiling.session()
    assert second is not first
    assert [r.name for r in second.records] == ["eval.step"]
    assert second.counts == {"serve.rows": 4}
    assert [r.name for r in first.records] == ["loader.wait"]


def test_a_span_open_across_sessions_lands_in_neither_new_one():
    go, done = threading.Event(), threading.Event()

    def other():
        with profiling.span("serve.wait"):
            go.set()
            done.wait(timeout=30)

    with _profile():
        th = threading.Thread(target=other)
        th.start()
        go.wait(timeout=30)
    with _profile():
        done.set()
        th.join(timeout=30)
    assert profiling.session().named("serve.wait") == []


def test_a_span_lies_on_the_profiler_clock_as_a_host_operation():
    """Its record function starts within 1 ms of the span, and is of function
    scope, as an operator's (a user annotation, scope 7, would take the
    device-side range of the kernels inside from any annotation around it)."""
    with _profile() as p:
        for _ in range(3):
            with torch.profiler.record_function("around"):
                with profiling.span("serve.collate"):
                    torch.ones(32, 32) @ torch.ones(32, 32)
    spans = profiling.session().named("serve.collate")
    t0 = p.profiler.kineto_results.trace_start_ns()
    events = sorted((e for e in p.events() if e.name == "serve.collate"),
                    key=lambda e: e.time_range.start)
    assert len(events) == len(spans) == 3
    for r, e in zip(sorted(spans, key=lambda r: r.start_ns), events):
        assert abs(t0 + 1000 * e.time_range.start - r.start_ns) < 1e6
        assert e.scope == 0 and e.cpu_parent is not None and e.cpu_parent.name == "around"


def test_parents_requests_and_no_span_inside_its_own_name():
    B, S, H, D = 1, 8, 2, 8
    qkv = torch.randn(B, S, 3 * H * D)
    cos, sin = torch.ones(B, S, D), torch.zeros(B, S, D)
    with _profile():
        with profiling.span("serve.call", rows=1, requests=[7, 8]):
            # the fallback route calls mha inside fused_rope_attention: one attn
            attention.fused_rope_attention(qkv, cos, sin, n_heads=H, n_kv_heads=H, head_dim=D)
            with profiling.span("w8a8"):
                quant_epilogue.row_quant(torch.randn(4, 16))
            quant_epilogue.rms_quant(torch.randn(4, 16), torch.ones(16))
        with profiling.span("serve.prep", request=9):
            pass
    s = profiling.session()
    (call,) = s.named("serve.call")
    assert call.attrs == {"rows": 1, "requests": [7, 8]} and call.parent is None
    assert [r.parent for r in s.named("attn")] == [call.id]
    assert [r.parent for r in s.named("w8a8")] == [call.id, call.id]
    assert s.named("serve.prep")[0].request == 9
    for r in s.records:  # children end first, inside their parent
        if r.parent is not None:
            p = next(x for x in s.records if x.id == r.parent)
            assert p.start_ns <= r.start_ns <= r.end_ns <= p.end_ns


def test_threads_lose_no_count_or_record():
    """More threads than cores, switching every microsecond."""
    n_threads, n = (os.cpu_count() or 1) + 4, 200

    def work():
        for _ in range(n):
            profiling.count("serve.rows", 1)
            with profiling.span("loader.collate"):
                pass

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with _profile():
            threads = [threading.Thread(target=work) for _ in range(n_threads)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    s = profiling.session()
    assert s.counts == {"serve.rows": n_threads * n}
    assert len(s.named("loader.collate")) == n_threads * n


def test_records_are_bounded():
    s = profiling.Session(limit=2)
    for i in range(5):
        s.add(profiling.Record(i, "attn", 0, 1, 0, None, None, {}))
    assert len(s.records) == 2 and s.dropped == 3


def test_unknown_names_are_refused_while_recording():
    with _profile():
        with pytest.raises(KeyError):
            with profiling.span("no.such.span"):
                pass
        with pytest.raises(KeyError):
            profiling.count("no.such.counter")


def test_the_table_names_every_span_and_counter_the_package_uses():
    used = {}
    pat = re.compile(r'\b(span|spanned|count|record)\(\s*"([^"]+)"')
    for d, _, files in os.walk(PKG):
        for f in files:
            if f.endswith(".py") and f != "profiling.py":
                with open(os.path.join(d, f)) as fh:
                    for fn, name in pat.findall(fh.read()):
                        used.setdefault(name, set()).add(fn)
    assert set(used) == set(profiling.NAMES)
    fill = {"serve.tokens", "serve.tokens_padded", "serve.patches", "serve.patches_padded"}
    assert fill <= {n for n, v in profiling.NAMES.items() if v.kind == "counter"}
    assert all(used[n] == {"count"} for n in fill | {"serve.pad_rows"})
    kinds = {"span": {"span", "spanned"}, "interval": {"record"}, "counter": {"count"}}
    for name, fns in used.items():
        assert fns <= kinds[profiling.NAMES[name].kind], (name, fns)
