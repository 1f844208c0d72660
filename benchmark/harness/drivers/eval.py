"""Batch evaluation: the port's ``batch_rm_inference`` over pairwise rows of
PNG files, as ``eval_batch_inference`` runs it (its ``PrefetchLoader``, the
registry's processor, ``micro_batch_size`` pairs a device call, a fixed
sequence length), closed loop.

The rows are drawn from the seed: ``rows_per_second * seconds`` pairs
(rounded up to whole batches) over a pool of seeded images of the traffic's
sizes, written as PNG files to ``TMPDIR`` at set-up. Set-up also scores one
batch of each crop bucket the rows use. The window is the one call that
scores every row; ``score_pairs_per_s`` is the pairs over its wall time.

Each device call's rewards are kept as the timed path returns them. After
the window a seeded sample of pairs, the one with the most image tokens
among them, is scored again by the plain reference from the same files
(and, for ``control.py``, by the reference one precision below).
"""

from __future__ import annotations

import gc
import math
import os
import shutil
import tempfile
import time

import numpy as np
import torch

from .. import common, family, flops, inputs, program, spans, weights
from ..compare import checks, control_gaps, reference_variants, reward_gaps, within
from ..trace import Tracer


class Recorder:
    """Wraps the adaptor's score function: keeps each call's rewards, and
    opens the traced part before call ``trace_calls[0]`` of the window and
    closes it after call ``trace_calls[1]``."""

    def __init__(self, adaptor):
        self.calls = 0
        self.rewards = []
        self.tracer = None
        self.trace_calls = (-1, -1)
        make = adaptor.make_score_fn

        def make_recorded(*a, **kw):
            score = make(*a, **kw)

            def recorded(params, batch):
                k = self.calls
                if self.tracer is not None and k == self.trace_calls[0]:
                    self.tracer.start()
                r = score(params, batch)
                self.rewards.append(r.detach().clone())
                self.calls += 1
                if self.tracer is not None and k == self.trace_calls[1]:
                    self.tracer.stop()
                return r

            return recorded

        adaptor.make_score_fn = make_recorded

    def reset(self):
        self.calls, self.rewards = 0, []


def build(cfg, traffic, seed, device, seconds=10.0):
    """Inputs, files, the port's adaptor and processor for one seed."""
    tok = inputs.WordTokenizer(cfg["family"], cfg["tokens"], cfg["text"]["vocab_size"], seed)
    pool = inputs.image_pool(traffic["image_sizes"], traffic["images_per_size"])
    bs = traffic["pairs_per_call"]
    n = bs * math.ceil(seconds * traffic["rows_per_second"] / bs)
    prs = inputs.pairs(seed, pool, n)
    prompts = inputs.prompts(seed, n, *traffic["prompt_words"])
    texts = [inputs.render(cfg["family"], tok, p) for p in prompts]
    tmp = tempfile.mkdtemp(prefix="bench_eval_")
    pngs = [inputs.png_bytes(inputs.pixels(seed, im)) for im in pool]
    paths = []
    for im, b in zip(pool, pngs):
        paths.append(os.path.join(tmp, f"{im.key}.png"))
        with open(paths[-1], "wb") as f:
            f.write(b)
    rows = [{"prompt": prompts[i], "chosen_path": paths[a], "reject_path": paths[b]}
            for i, (a, b) in enumerate(prs)]
    w = weights.make_weights(cfg, seed, device=device)
    ad = program.adaptor(cfg, w, quantize=traffic.get("quantize"), device=device,
                         min_size=traffic.get("quantize_min_size", 1 << 20))
    proc = program.processor(cfg, tok, ad.cfg)
    return dict(tok=tok, pool=pool, pngs=pngs, paths=paths, tmp=tmp, rows=rows, pairs=prs,
                texts=texts, adaptor=ad, proc=proc)


def warm_rows(st, traffic, cfg):
    """One batch for each image grid the pool holds (crops for phi3v): pairs
    of that grid's images, so every batch shape of the window has run once."""
    bs = traffic["pairs_per_call"]
    by_grid = {}
    for k, im in enumerate(st["pool"]):
        grid = family.row_shape(cfg, st["tok"], "", im.width, im.height)[2]
        by_grid.setdefault(grid[0] * grid[1], []).append(k)
    rows = []
    for keys in by_grid.values():
        for j in range(bs):
            a, b = keys[j % len(keys)], keys[(j + 1) % len(keys)]
            rows.append({"prompt": st["rows"][j]["prompt"], "chosen_path": st["paths"][a],
                         "reject_path": st["paths"][b]})
    return rows


def score(st, traffic, rows):
    from llava_reward_torch.evalx.batch_inference import batch_rm_inference

    return batch_rm_inference(st["adaptor"], rows, st["tok"], st["proc"],
                              batch_size=traffic["pairs_per_call"], seq_len=traffic["seq_len"],
                              num_workers=traffic["loader_workers"], progress=False)


def call_work(cfg, st, traffic):
    """The work of each device call of the window, from its rows' shapes."""
    bs = traffic["pairs_per_call"]
    w8a8 = traffic.get("quantize") == "w8a8"
    works = []
    for k in range(0, len(st["pairs"]), bs):
        rows = []
        for i in range(k, min(k + bs, len(st["pairs"]))):
            for side in st["pairs"][i]:
                im = st["pool"][side]
                rows.append(family.row_shape(cfg, st["tok"], st["texts"][i], im.width,
                                             im.height))
        slots = max(m for _, m, _ in rows)
        w = flops.Work()
        for shape in rows:
            w += family.row_work(cfg, shape, slots, w8a8)
        works.append(w)
    return works


def program_rewards(st):
    """(pairs, 2, dim) rewards of the window's calls, chosen and rejected."""
    out = []
    for r in st["recorder"].rewards:
        r = r.float().cpu().numpy()
        k = r.shape[0] // 2
        out.extend(np.stack([r[:k], r[k:]], 1))
    return np.asarray(out)


def sample(st, traffic, seed, cfg):
    """A seeded sample of pairs: the one with the most tokens, then others at
    random."""
    n = len(st["pairs"])
    tokens = [sum(family.row_shape(cfg, st["tok"], st["texts"][i], st["pool"][s].width,
                                   st["pool"][s].height)[0] for s in st["pairs"][i])
              for i in range(n)]
    first = int(np.argmax(tokens))
    rest = [i for i in inputs.rng(seed, 5).permutation(n) if i != first]
    return [first] + [int(i) for i in rest[: traffic["checked_pairs"] - 1]]


def reference_rewards(st, cfg, traffic, seed, picks, device, controls=None):
    """The plain reference's rewards of the picked pairs at the cell's
    precision, from the same files and the weights made again from the seed:
    in float32, and with every op rounded to bfloat16 (the seed's yardstick,
    ``compare.py``); and each of ``controls`` (``control.py``'s)."""
    from ...reference.common import control, rounding, strict_fp32

    strict_fp32()
    w = weights.make_weights(cfg, seed, device=device)
    bs = traffic["pairs_per_call"]
    w8a8 = traffic.get("quantize") == "w8a8"
    out = {}
    for name, dtype, schemes in reference_variants(controls):
        rows = []
        with rounding(dtype), control(schemes):
            for i in picks:
                k = i - i % bs
                call = [s for j in range(k, min(k + bs, len(st["pairs"])))
                        for s in st["pairs"][j]]
                slots = max(family.row_shape(cfg, st["tok"], "", st["pool"][s].width,
                                             st["pool"][s].height)[1] for s in call)
                rows.append([family.ref_reward(cfg, w, st["tok"], st["texts"][i], st["pngs"][s],
                                               slots, device, w8a8) for s in st["pairs"][i]])
        out[name] = np.asarray(rows)
    del w
    return out


def run(cfg, traffic, limits, seed, seconds, trace, device, t_start, controls=None,
        span_entries=None):
    if device == "cuda":
        torch.cuda.reset_peak_memory_stats()
    st = build(cfg, traffic, seed, device, seconds)
    spans.install(span_entries or {})
    rec = st["recorder"] = Recorder(st["adaptor"])
    score(st, traffic, warm_rows(st, traffic, cfg))
    if device == "cuda":
        torch.cuda.synchronize()
    rec.reset()
    if trace:
        n_calls = math.ceil(len(st["rows"]) / traffic["pairs_per_call"])
        a, b = traffic["traced_part"]
        rec.tracer = Tracer()
        rec.trace_calls = (int(a * n_calls), max(int(a * n_calls), int(b * n_calls) - 1))
    t0 = time.perf_counter()
    setup_s = t0 - t_start
    score(st, traffic, st["rows"])
    if device == "cuda":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() if device == "cuda" else 0

    got = program_rewards(st)
    attempted = len(st["pairs"])
    layer = None
    if trace:
        a, b = rec.trace_calls
        works = call_work(cfg, st, traffic)
        layer = {"trace": rec.tracer.finish(), "wall_s": wall - rec.tracer.overhead_s,
                 "calls": works, "traced": [a <= k <= b for k in range(len(works))],
                 "role": "eval"}
    picks = sample(st, traffic, seed, cfg)
    st["adaptor"] = st["proc"] = st["recorder"] = rec = None
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()
    ref = reference_rewards(st, cfg, traffic, seed, picks, device, controls)
    shutil.rmtree(st["tmp"], ignore_errors=True)
    finite = np.isfinite(got).all(axis=(1, 2)) if len(got) else np.zeros(0, bool)
    failed = attempted - int(finite.sum())
    gaps = reward_gaps(got[picks] if len(got) == attempted else None, ref["fp32"], ref["bf16"])
    checked = dict(checks(gaps, limits),
                   pairs_failed={"value": failed, "limit": 0})
    correct = within(checked)
    metrics = {"setup_s": setup_s, "score_pairs_per_s": attempted / wall,
               "peak_mem_gib": peak / 2 ** 30}
    dev = common.device_info(device, 1, peak)
    return {"correct": bool(correct), "attempted": attempted, "failed": failed,
            "metrics": metrics, "device": dev, "checks": checked, "layer_data": layer,
            "gaps": gaps, "control_gaps": control_gaps(ref, limits, controls)}
