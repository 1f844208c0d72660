"""Serving: the port's HTTP server (``evalx/server.py``: ``RewardService``
with its batcher, ``make_handler``, a ``ThreadingHTTPServer`` on
127.0.0.1), built in this process as ``server.main`` builds it, with the
decoder quantized as the traffic file says. Closed loop: ``clients``
processes' worth of waiting callers in one process of their own
(``clients.py``) send ``/score_pair`` with two base64 PNGs for ``--seconds``.

``serve_p95_s`` is the 95th percentile of the latency of every request sent
in the window, a failed one counted as slower than any other. Set-up scores
each batch bucket the load reaches (2, 4 and 8 rows) once, through the
service, and sends one request over HTTP.

After the window a seeded sample of the answered requests, the one with
the most image patches among them, is scored again by the plain reference
and compared with the rewards in the replies (and, for ``control.py``, by
the reference one precision below).
"""

from __future__ import annotations

import gc
import json
import math
import subprocess
import sys
import threading
import time

import numpy as np
import torch

from .. import common, family, flops, inputs, program, spans, weights
from ..clients import requests_for
from ..compare import checks, control_gaps, reference_variants, reward_gaps, within
from ..trace import Tracer


class Recorder:
    """Wraps the service's device call (each call's rows' shapes and whether
    the traced part held it) and its processor (host ms an image)."""

    def __init__(self, service, cfg):
        self.cfg = cfg
        self.calls, self.traced, self.prep_s = [], [], []
        self.tracer = None
        self.prime = False  # profile one warm-up call on the batcher's thread
        score, proc = service._score_samples, service.processor

        def score_samples(samples):
            if self.prime:
                # the profiler's first start on a thread sets up its tracing
                # there; pay that in set-up, not in the traced part
                self.prime = False
                first = Tracer()
                first.start()
                out = score(samples)
                first.stop()
                return out
            tr = self.tracer
            if tr is not None:
                tr.before_call()
            out = score(samples)
            self.calls.append([(len(s.input_ids), s.grid_thw[1], s.grid_thw[2])
                               for s in samples])
            self.traced.append(tr is not None and tr.running)
            if tr is not None:
                tr.after_call()
            return out

        service._score_samples = score_samples
        service.processor = _TimedProcessor(proc, self.prep_s)

    def call_work(self, w8a8: bool):
        """The work of each recorded call, from its rows' shapes."""
        merge = self.cfg["vision"]["spatial_merge_size"] ** 2
        works = []
        for rows in self.calls:
            w = flops.Work()
            for n, gh, gw in rows:
                units = gh * gw // merge
                w += family.row_work(self.cfg, (n, units, (gh, gw)), units, w8a8)
            works.append(w)
        return works

    def reset(self):
        self.calls, self.traced = [], []
        self.prep_s.clear()


class _TimedProcessor:
    """The service's processor, its calls timed (host seconds an image); its
    other attributes are the processor's."""

    def __init__(self, proc, sink):
        self._proc, self._sink = proc, sink

    def __call__(self, text, images, *a, **kw):
        t0 = time.perf_counter()
        out = self._proc(text, images, *a, **kw)
        self._sink.append((time.perf_counter() - t0) / max(len(images), 1))
        return out

    def __getattr__(self, name):
        return getattr(self._proc, name)


def _pctl(values, q: float) -> float:
    """The ``q`` quantile by nearest rank."""
    v = sorted(values)
    return v[min(len(v) - 1, max(0, math.ceil(q * len(v)) - 1))]


def run(cfg, traffic, limits, seed, seconds, trace, device, t_start, controls=None,
        span_entries=None):
    if device == "cuda":
        torch.cuda.reset_peak_memory_stats()
    load = subprocess.Popen([sys.executable, "-m", "benchmark.harness.clients", "--seed",
                             str(seed), "--traffic", json.dumps(traffic)], cwd=common.ROOT,
                            stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True)
    try:
        return _run(cfg, traffic, limits, seed, seconds, trace, device, t_start, load,
                    controls, span_entries)
    finally:
        if load.poll() is None:
            load.kill()
        load.wait()


def _run(cfg, traffic, limits, seed, seconds, trace, device, t_start, load, controls,
         span_entries):
    from http.server import ThreadingHTTPServer

    from llava_reward_torch.evalx.server import RewardService, make_handler

    quant = traffic.get("quantize")
    tok = inputs.WordTokenizer(cfg["family"], cfg["tokens"], cfg["text"]["vocab_size"], seed)
    ad = program.adaptor(cfg, weights.make_weights(cfg, seed, device=device), quantize=quant,
                         device=device, min_size=traffic.get("quantize_min_size", 1 << 20))
    proc = program.processor(cfg, tok, ad.cfg)
    service = RewardService(ad, tok, proc, seq_len=traffic["seq_len"],
                            max_batch=traffic["max_batch"],
                            batch_window_ms=traffic["batch_window_ms"])
    spans.install(span_entries or {})
    rec = Recorder(service, cfg)
    server = ThreadingHTTPServer(("127.0.0.1", 0), make_handler(service))
    th = threading.Thread(target=server.serve_forever, daemon=True)
    th.start()
    try:
        pool, reqs = requests_for(seed, traffic)
        pngs = {}

        def png(k):
            if k not in pngs:
                pngs[k] = inputs.png_bytes(inputs.pixels(seed, pool[k]))
            return pngs[k]

        # warm-up, through the batcher's thread: each bucket the load reaches
        # (2, 4, ... max_batch rows), then one request over HTTP
        rec.prime = trace
        warm = [reqs[i] for i in range(traffic["max_batch"] // 2)]
        imgs = [_data_uri(png(k)) for a, b, _ in warm for k in (a, b)]
        n = 2
        while n <= traffic["max_batch"]:
            service.score(warm[0][2], imgs[:n])
            n *= 2
        _warm_http(server.server_port, warm[0], png)
        if device == "cuda":
            torch.cuda.synchronize()
        if load.stdout.readline().strip() != "ready":
            raise RuntimeError("the load process did not start")
        rec.reset()
        t0 = time.perf_counter()
        if trace:
            a, b = traffic["traced_part"]
            rec.tracer = Tracer(t0 + a * seconds, t0 + b * seconds)
        setup_s = t0 - t_start
        load.stdin.write(f"go {server.server_port} {seconds}\n")
        load.stdin.flush()
        res = json.loads(load.stdout.readline())
        wall = time.perf_counter() - t0
    finally:
        server.shutdown()
        server.server_close()
        th.join()
    peak = torch.cuda.max_memory_allocated() if device == "cuda" else 0
    done = res["requests"]
    ok = [r for r in done if r.get("status") == 200]
    lat = [r["t1"] - r["t0"] if r.get("status") == 200 else float("inf") for r in done]
    metrics = {"setup_s": setup_s, "serve_p95_s": _pctl(lat, 0.95) if lat else float("inf"),
               "peak_mem_gib": peak / 2 ** 30}
    layer = None
    if trace:
        traced = rec.tracer.finish() or None
        rows = [len(c) for c in rec.calls]
        layer = {"role": "serve", "wall_s": wall - rec.tracer.overhead_s,
                 "calls": rec.call_work(quant == "w8a8"), "traced": rec.traced,
                 "rows_per_call": float(np.mean(rows)) if rows else None,
                 "host_prep_ms": 1e3 * float(np.mean(rec.prep_s)) if rec.prep_s else None,
                 "trace": traced or {"busy_s": 0.0, "window_s": 0.0, "spans": {},
                                     "device_ops": [], "idle_gaps": []}}
    ad.params.clear()
    ad._score_fns.clear()
    service = rec = server = proc = ad = None
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()

    # the check: a seeded sample of the answered requests, the largest first
    picks = _sample(ok, reqs, pool, traffic, seed)
    strict = weights.make_weights(cfg, seed, device=device)
    from ...reference.common import control, rounding, strict_fp32

    strict_fp32()
    got = [[r["chosen"], r["rejected"]] for r in picks]
    ref = {}
    for name, dtype, schemes in reference_variants(controls):
        ref[name] = []
        with rounding(dtype), control(schemes):
            for r in picks:
                a, b, prompt = reqs[r["i"]]
                text = inputs.render(cfg["family"], tok, prompt)
                ref[name].append([family.ref_reward(cfg, strict, tok, text, png(k), 0, device,
                                                    traffic.get("quantize") == "w8a8")
                                  for k in (a, b)])
    del strict
    gaps = reward_gaps(got if picks else None, ref["fp32"], ref["bf16"])
    failed = len(done) - len(ok)
    checked = dict(checks(gaps, limits), requests_failed={"value": failed, "limit": 0})
    dev = common.device_info(device, 1, peak)
    return {"correct": within(checked), "attempted": len(done), "failed": failed,
            "metrics": metrics, "device": dev, "checks": checked, "layer_data": layer,
            "gaps": gaps, "control_gaps": control_gaps(ref, limits, controls) if picks else None}


def _data_uri(png: bytes) -> str:
    import base64

    return "data:image/png;base64," + base64.b64encode(png).decode()


def _warm_http(port, req, png):
    import http.client

    a, b, prompt = req
    body = json.dumps({"prompt": prompt, "chosen": _data_uri(png(a)),
                       "rejected": _data_uri(png(b))})
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=300)
    conn.request("POST", "/score_pair", body=body, headers={"Content-Type": "application/json"})
    resp = conn.getresponse()
    resp.read()
    conn.close()
    if resp.status != 200:
        raise RuntimeError(f"warm-up request: HTTP {resp.status}")


def _sample(ok, reqs, pool, traffic, seed):
    """The answered request with the most image patches, then others drawn
    from the seed."""
    if not ok:
        return []
    size = [pool[reqs[r["i"]][0]].width * pool[reqs[r["i"]][0]].height
            + pool[reqs[r["i"]][1]].width * pool[reqs[r["i"]][1]].height for r in ok]
    first = int(np.argmax(size))
    order = [int(j) for j in inputs.rng(seed, 6).permutation(len(ok)) if j != first]
    return [ok[first]] + [ok[j] for j in order[: traffic["checked_requests"] - 1]]
