"""The serving fill metrics, ``port.serve.token_fill`` and
``port.serve.patch_fill``: each reads the port's ``serve.tokens`` /
``serve.patches`` counters over their padded twins on synthetic counters, and
gives None without them (no traced part, no counters, a port that records
nothing, an evaluation run)."""

import pytest

import helpers  # noqa: F401  (the repository on the path)

from benchmark.harness import common
from llava_reward_torch.utils import profiling

COUNTS = {"serve.calls": 3, "serve.rows": 16, "serve.tokens": 5400,
          "serve.tokens_padded": 7200, "serve.patches": 60000, "serve.patches_padded": 96000}
WANT = {"port.serve.token_fill": 75.0, "port.serve.patch_fill": 62.5}


def _session(counts):
    s = profiling.Session()
    for name, n in counts.items():
        s.count(name, n)
    return s


def _data(role="serve", window_s=2.0):
    return {"role": role, "trace": {"window_s": window_s, "spans": {}}}


@pytest.mark.parametrize("name", sorted(WANT))
def test_fill_on_synthetic_counters(monkeypatch, name):
    mod = common.load_metric(name)
    monkeypatch.setattr(profiling, "_session", _session(COUNTS))
    assert common.read_layer_metric(mod, _data()) == pytest.approx(WANT[name])
    assert common.read_layer_metric(mod, _data("eval")) is None
    assert common.read_layer_metric(mod, _data(window_s=0.0)) is None  # no traced part
    assert common.read_layer_metric(mod, None) is None


@pytest.mark.parametrize("name", sorted(WANT))
def test_fill_reads_none_without_its_counters(monkeypatch, name):
    """A parent that counts rows but neither tokens nor patches, a text-only
    call (tokens but no patches), and a port that records nothing."""
    mod = common.load_metric(name)
    rows_only = {k: COUNTS[k] for k in ("serve.calls", "serve.rows")}
    monkeypatch.setattr(profiling, "_session", _session(rows_only))
    assert common.read_layer_metric(mod, _data()) is None
    monkeypatch.setattr(profiling, "_session", _session(
        {k: v for k, v in COUNTS.items() if "patches" not in k}))
    got = common.read_layer_metric(mod, _data())
    assert (got is None) == (name == "port.serve.patch_fill")
    monkeypatch.setattr(profiling, "_session", profiling.Session())
    assert common.read_layer_metric(mod, _data()) is None
    monkeypatch.delattr(profiling, "session")
    assert common.read_layer_metric(mod, _data()) is None
