"""Where a traced benchmark run's time goes, from the port's own spans
(``llava_reward_torch/utils/profiling.py``) laid on the device trace: one
cell run by ``benchmark/run.py`` with ``--trace 1``, in this process, and
then, from the traced part,

- the device's idle time split by the span the thread that drives the card
  was in (its innermost: ``serve.wait``, ``serve.collate``, ``attn``,
  ``loader.wait``, ...; ``none`` outside every span), sampled every 50 us;
- in serving, each request's time in the port: ``serve.prep``,
  ``serve.queue``, and the ``serve.collate`` and ``serve.step`` of the last
  device call that carries its rows (their means, and the request at the
  median of their sum);
- the span and counter totals, and the profiler's start and stop on the host
  (``Tracer.overhead_s``; the only reading where the port records no spans).

    python tools/span_breakdown.py --workload <cell> --seed <n> --seconds <s>

The run's own result line is printed first, as ``benchmark/run.py`` prints
it; the breakdown follows as one ``BREAKDOWN {json}`` line.
"""

from __future__ import annotations

import argparse
import bisect
import json
import os
import statistics
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

STEP_NS = 50_000


def _idle_intervals(prof):
    """The device's idle intervals inside the span of its kernels, in ns on
    the profiler's clock."""
    from benchmark.harness import spans, trace

    t0 = prof.profiler.kineto_results.trace_start_ns()
    dev = [(t0 + 1000 * e.time_range.start, t0 + 1000 * e.time_range.end)
           for e in prof.events() if trace._is_device(e) and e.name not in spans.NAMES]
    busy = trace._union(dev)
    return [(b0, a1) for (_, b0), (a1, _) in zip(busy, busy[1:])]


def _innermost(recs, starts, t):
    """The innermost span of one thread that holds instant ``t``."""
    i = bisect.bisect_right(starts, t) - 1
    while i >= 0:
        if recs[i].end_ns >= t:
            return recs[i].name
        i -= 1
    return "none"


def idle_by_span(prof, records, thread):
    from llava_reward_torch.utils.profiling import NAMES

    recs = sorted((r for r in records if r.thread == thread and NAMES[r.name].kind == "span"),
                  key=lambda r: r.start_ns)
    starts = [r.start_ns for r in recs]
    out = {}
    for a, b in _idle_intervals(prof):
        t = a
        while t < b:
            d = min(STEP_NS, b - t)
            name = _innermost(recs, starts, t + d // 2)
            out[name] = out.get(name, 0.0) + d / 1e9
            t += d
    return dict(sorted(out.items(), key=lambda kv: -kv[1]))


def request_split(session):
    """Each request's ms in the port: prep, queue, and the collate and step of
    the last call that carries its rows."""
    prep = {r.request: r for r in session.named("serve.prep")}
    queue = {r.request: r for r in session.named("serve.queue")}
    children = {}
    for r in session.named("serve.collate") + session.named("serve.step"):
        children.setdefault(r.parent, {})[r.name] = r
    last = {}
    for c in sorted(session.named("serve.call"), key=lambda r: r.start_ns):
        for rid in c.attrs.get("requests") or []:
            last[rid] = c
    rows = []
    for rid in sorted(set(prep) & set(queue) & set(last)):
        kids = children.get(last[rid].id, {})
        if len(kids) == 2:
            rows.append({"request": rid, "prep": 1e3 * prep[rid].seconds,
                         "queue": 1e3 * queue[rid].seconds,
                         "collate": 1e3 * kids["serve.collate"].seconds,
                         "step": 1e3 * kids["serve.step"].seconds,
                         "in_port": (last[rid].end_ns - prep[rid].start_ns) / 1e6})
    if not rows:
        return None
    keys = ("prep", "queue", "collate", "step", "in_port")
    rows.sort(key=lambda r: r["in_port"])
    return {"requests": len(rows), "mean_ms": {k: statistics.fmean(r[k] for r in rows)
                                               for k in keys},
            "median_request_ms": rows[len(rows) // 2]}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    args, rest = p.parse_known_args(argv)  # the rest goes to benchmark/run.py

    sys.path.insert(0, os.path.join(ROOT, "benchmark"))
    import run

    from benchmark.harness import trace
    from llava_reward_torch.utils import profiling

    seen = {}
    summarize, finish = trace.summarize, trace.Tracer.finish
    spans = hasattr(profiling, "session")  # a commit before the port's spans has none

    def keep(prof, window_s):
        if spans:
            records = profiling.session().records
            threads = {r.thread for r in records if r.name in ("serve.call", "eval.step")}
            seen["idle_s"] = {str(t): idle_by_span(prof, records, t) for t in threads}
        return summarize(prof, window_s)

    def finish_kept(self):
        seen["tracer_overhead_s"] = self.overhead_s
        return finish(self)

    trace.summarize, trace.Tracer.finish = keep, finish_kept
    rc = run.main(["--workload", args.workload, "--seed", str(args.seed), "--seconds",
                   str(args.seconds), "--trace", "1", *rest])
    if spans:
        s = profiling.session()
        totals = {}
        for r in s.records:
            n, t = totals.get(r.name, (0, 0.0))
            totals[r.name] = (n + 1, t + r.seconds)
        seen.update(requests=request_split(s), counts=s.counts, dropped=s.dropped,
                    spans={k: {"n": n, "s": t} for k, (n, t) in sorted(totals.items())})
    print("BREAKDOWN " + json.dumps(seen), flush=True)
    return rc


if __name__ == "__main__":
    rc = main()
    sys.stdout.flush()
    os._exit(rc)  # the serving batcher's thread blocks for ever on its queue
