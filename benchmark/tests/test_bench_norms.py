"""The norm layer's metrics: ``port.eval.norm_kernel_share`` reads the port's
``norm.kernel_rows`` / ``norm.plain_rows`` counters, ``norm_ms.eval`` and
``norm_ms.serve`` the device seconds under the benchmark's ``bench.norm`` span
over the traced calls; each gives None where what it reads is not there (no
traced part, no counters or span, a port that records nothing, the other
role), as on a commit before the norm kernel."""

import pytest

import helpers  # noqa: F401  (the repository on the path)

from benchmark.harness import common
from llava_reward_torch.utils import profiling


def _session(counts):
    s = profiling.Session()
    for name, n in counts.items():
        s.count(name, n)
    return s


def _data(role="eval", window_s=2.0, span_s=None, traced=(True, True, False, True)):
    spans = {} if span_s is None else {"bench.norm": span_s}
    return {"role": role, "trace": {"window_s": window_s, "spans": spans},
            "traced": list(traced)}


@pytest.mark.parametrize("counts,want", [
    ({"norm.kernel_rows": 3 * 87040, "norm.plain_rows": 87040}, 75.0),
    ({"norm.kernel_rows": 5000}, 100.0),
    ({"norm.plain_rows": 5000, "serve.rows": 4}, 0.0),
])
def test_kernel_share_on_synthetic_counters(monkeypatch, counts, want):
    mod = common.load_metric("port.eval.norm_kernel_share")
    monkeypatch.setattr(profiling, "_session", _session(counts))
    assert common.read_layer_metric(mod, _data()) == pytest.approx(want)
    assert common.read_layer_metric(mod, _data("serve")) is None
    assert common.read_layer_metric(mod, _data(window_s=0.0)) is None  # no traced part
    assert common.read_layer_metric(mod, None) is None


def test_kernel_share_reads_none_without_its_counters(monkeypatch):
    mod = common.load_metric("port.eval.norm_kernel_share")
    monkeypatch.setattr(profiling, "_session", _session({"serve.rows": 4}))  # a parent's
    assert common.read_layer_metric(mod, _data()) is None
    monkeypatch.setattr(profiling, "_session", profiling.Session())
    assert common.read_layer_metric(mod, _data()) is None
    monkeypatch.delattr(profiling, "session")  # a port that records nothing
    assert common.read_layer_metric(mod, _data()) is None


@pytest.mark.parametrize("name,role", [("norm_ms.eval", "eval"), ("norm_ms.serve", "serve")])
def test_norm_ms_on_a_synthetic_trace(name, role):
    mod = common.load_metric(name)
    other = "serve" if role == "eval" else "eval"
    # 0.45 s under the span over three traced calls
    assert common.read_layer_metric(mod, _data(role, span_s=0.45)) == pytest.approx(150.0)
    assert common.read_layer_metric(mod, _data(other, span_s=0.45)) is None
    assert common.read_layer_metric(mod, _data(role)) is None  # the span read nothing
    assert common.read_layer_metric(mod, _data(role, span_s=0.45, traced=(False,))) is None
    assert common.read_layer_metric(mod, None) is None


def test_both_norm_ms_metrics_wrap_the_same_entries_and_they_exist():
    import importlib

    eval_spans = common.load_metric("norm_ms.eval").SPANS
    assert eval_spans == common.load_metric("norm_ms.serve").SPANS
    assert list(eval_spans) == ["bench.norm"]
    for mod, attr in eval_spans["bench.norm"]:
        assert callable(getattr(importlib.import_module(mod), attr)), (mod, attr)
