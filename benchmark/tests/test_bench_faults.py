"""The whole of a run with the timed path broken underneath, the chip's check
skipped (the CPU): ``correct`` comes out false for each fault a scoring cell
can have (an answer altered where it is produced, an answer that never
comes), and for each cell's control, the reference one precision below
what the cell states (fp8 products for bf16, W4A4 for W8A8)."""

import json
import os
import time

import pytest
import torch

from helpers import HERE, REPO, TINY_EVAL, TINY_SERVE

from benchmark.harness import common, program

common.set_environment()


def _load(kind, name):
    with open(os.path.join(REPO, "benchmark", kind, f"{name}.json")) as f:
        return json.load(f)


def _cfg(name):
    with open(os.path.join(HERE, "data", f"{name}.json")) as f:
        return json.load(f)


LIMIT = 2.2  # the cells' limit on reward_gap_bf16_units


def _eval(limit=LIMIT, seed=21, with_control=False):
    from benchmark.harness.drivers import eval as drv

    traffic = dict(_load("traffic", "eval.bf16"), **TINY_EVAL)
    return drv.run(_cfg("tiny_phi3v"), traffic, {"reward_gap_bf16_units": limit}, seed=seed,
                   seconds=2, trace=False, device="cpu", t_start=time.perf_counter(),
                   controls={"control": traffic["control"]} if with_control else None)


def _serve(limit=LIMIT, seed=22, with_control=False, **over):
    from benchmark.harness.drivers import serve as drv

    traffic = dict(_load("traffic", "serve.w8a8"), **TINY_SERVE)
    traffic.update(over)
    return drv.run(_cfg("tiny_qwen"), traffic, {"reward_gap_bf16_units": limit}, seed=seed,
                   seconds=2, trace=False, device="cpu", t_start=time.perf_counter(),
                   controls={"control": traffic["control"]} if with_control else None)


def _altered(score):
    """Every answer of the call off by a tenth of its size: the sampled rows
    see it whichever they are."""
    def altered(params, batch):
        r = score(params, batch)
        return r + 0.1 * r.abs().amax(dim=-1, keepdim=True)
    return altered


def test_sound_runs_are_correct():
    assert _eval()["correct"]
    assert _serve()["correct"]


def test_eval_an_answer_altered_where_it_is_produced(monkeypatch):
    build = program.adaptor

    def faulty(*a, **kw):
        ad = build(*a, **kw)
        make = ad.make_score_fn
        ad.make_score_fn = lambda *x, **y: _altered(make(*x, **y))
        return ad

    monkeypatch.setattr(program, "adaptor", faulty)
    out = _eval()
    assert not out["correct"]
    c = out["checks"]["reward_gap_bf16_units"]
    assert c["value"] > c["limit"]


def test_eval_an_answer_that_never_comes(monkeypatch):
    build = program.adaptor
    calls = []

    def faulty(*a, **kw):
        ad = build(*a, **kw)
        make = ad.make_score_fn

        def dropping(*x, **y):
            score = make(*x, **y)

            def f(params, batch):
                calls.append(1)
                r = score(params, batch)
                return r[:0] if len(calls) == 3 else r  # the window's first call
            return f
        ad.make_score_fn = dropping
        return ad

    monkeypatch.setattr(program, "adaptor", faulty)
    out = _eval()
    assert not out["correct"] and out["failed"] > 0


def test_serve_an_answer_altered_where_it_is_produced(monkeypatch):
    from llava_reward_torch.evalx import server

    score = server.RewardService._score_samples

    def altered(self, samples):
        r = score(self, samples)
        return r + 0.1 * abs(r).max(axis=-1, keepdims=True)

    monkeypatch.setattr(server.RewardService, "_score_samples", altered)
    out = _serve()
    assert not out["correct"]


def test_serve_a_request_that_fails(monkeypatch):
    from llava_reward_torch.evalx import server

    score = server.RewardService.score
    n = []

    def failing(self, caption, images):
        n.append(1)
        if len(n) == 6:  # after set-up's four requests
            raise RuntimeError("planted fault")
        return score(self, caption, images)

    monkeypatch.setattr(server.RewardService, "score", failing)
    out = _serve()
    assert not out["correct"] and out["failed"] == 1
    assert out["metrics"]["serve_p95_s"] == float("inf") or out["attempted"] > 20


@pytest.mark.parametrize("seed", [31, 32, 33])
def test_serve_control_int4_is_not_correct(seed):
    """The W4A4 control fails the cells' limit at the tiny size too, on the
    rows of a sound run."""
    out = _serve(seed=seed, with_control=True)
    assert out["correct"] and out["control_gaps"]["control"]["caught"]
    c = out["control_gaps"]["control"]["reward_gap_bf16_units"]
    assert c > LIMIT > out["gaps"]["reward_gap_bf16_units"]


@pytest.mark.parametrize("seed", [34, 35])
def test_eval_control_fp8_is_not_correct(seed):
    """The fp8 control fails the cells' limit at the tiny size too."""
    out = _eval(seed=seed, with_control=True)
    assert out["correct"] and out["control_gaps"]["control"]["caught"]
    assert out["control_gaps"]["control"]["reward_gap_bf16_units"] > LIMIT


def test_float32_program_reads_a_small_share_of_bf16_rounding():
    build = program.adaptor
    out = None
    try:
        program.adaptor = lambda *a, **kw: build(*a, **dict(kw, dtype=torch.float32))
        out = _eval(limit=1e-3)
    finally:
        program.adaptor = build
    assert out["correct"]
