"""The metrics that read the port's own spans and counters
(``llava_reward_torch.utils.profiling``): each reads synthetic records as it
should and gives None without them (no traced part, no records, a port that
records nothing); the traced tiny cells print them; every span of the port
that may hold a launch is registered by a metric of each cell, so that the
summarizer would read a device-side range of one as a span, never as a
kernel."""

import pytest

from helpers import last_json, make_root, run_cell

from benchmark.harness import common
from llava_reward_torch.utils import profiling

SERVE = ["queue_wait_ms.serve", "batcher_wait.serve", "call_host_ms.serve",
         "port.serve.rows_per_call", "port.host_prep_ms.serve"]
EVAL = ["loader_wait_ms.eval"]
MS = 1_000_000


def _session():
    s = profiling.Session()
    recs = [("serve.queue", 0, 30), ("serve.queue", 10, 60), ("serve.queue", 20, 110),
            ("serve.wait", 100, 300), ("serve.wait", 500, 600),
            ("serve.collate", 300, 304), ("serve.collate", 600, 608),
            ("serve.prep", 0, 12), ("serve.prep", 5, 23),
            ("loader.wait", 0, 2), ("loader.wait", 10, 11), ("loader.wait", 20, 26)]
    for i, (name, a, b) in enumerate(recs):
        attrs = {"images": 2} if name == "serve.prep" else {}
        s.add(profiling.Record(i, name, a * MS, b * MS, 1, None, None, attrs))
    s.count("serve.calls", 4)
    s.count("serve.rows", 22)
    s.count("serve.pad_rows", 10)
    return s


WANT = {"queue_wait_ms.serve": (30 + 50 + 90) / 3, "batcher_wait.serve": 100 * 0.3 / 2.0,
        "call_host_ms.serve": 6.0, "port.serve.rows_per_call": 5.5,
        "port.host_prep_ms.serve": (12 + 18) / 4, "loader_wait_ms.eval": 3.0}


def _data(role, window_s=2.0):
    return {"role": role, "trace": {"window_s": window_s, "spans": {}}}


@pytest.mark.parametrize("name", SERVE + EVAL)
def test_readers_on_synthetic_records(monkeypatch, name):
    mod = common.load_metric(name)
    role = "eval" if name in EVAL else "serve"
    monkeypatch.setattr(profiling, "_session", _session())
    assert common.read_layer_metric(mod, _data(role)) == pytest.approx(WANT[name])
    other = "eval" if role == "serve" else "serve"
    assert common.read_layer_metric(mod, _data(other)) is None
    assert common.read_layer_metric(mod, _data(role, window_s=0.0)) is None  # no traced part
    assert common.read_layer_metric(mod, None) is None
    monkeypatch.setattr(profiling, "_session", profiling.Session())
    assert common.read_layer_metric(mod, _data(role)) is None  # nothing recorded
    monkeypatch.delattr(profiling, "session")  # a port that records nothing
    assert common.read_layer_metric(mod, _data(role)) is None


def test_every_launching_span_is_registered_in_each_cell():
    launching = {n for n, v in profiling.NAMES.items() if v.kind == "span" and v.launches}
    assert {"serve.call", "serve.collate", "serve.step", "eval.step", "attn", "w8a8"} <= launching
    bench = common.load_benchmark()
    for cell in bench["workloads"]:
        mods = [common.load_metric(m["name"])
                for m in common.metrics_for(bench, cell["name"], "per_layer")]
        assert launching <= set(common.metric_spans(mods)), cell["name"]


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return make_root(str(tmp_path_factory.mktemp("bench")))


@pytest.mark.parametrize("cell,names", [("tiny.serve", SERVE), ("tiny.eval", EVAL)])
def test_traced_tiny_runs_print_the_port_metrics(root, cell, names):
    """Eight seconds, so that the traced part holds two device calls or more."""
    rc, out, err = run_cell(root, cell, seed=2 ** 31 + 9, seconds=8.0, trace=1)
    assert rc == 0, err[-3000:]
    line = last_json(out)
    assert line["correct"] is True
    bench = common.load_benchmark(root)
    for name in names:
        (m,) = [m for m in bench["per_layer"] if m["name"] == name]
        assert m["source"] in ("host_clock", "program_counter")
        assert line["metrics"][name]["value"] > 0, name
        assert line["metrics"][name]["unit"] == m["unit"]
