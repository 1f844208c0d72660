"""Real rows of each device call in serving's traced part, averaged: the
port's counters ``serve.rows`` over ``serve.calls`` (padding rows apart)."""

from benchmark.harness import port_records


def read(data):
    c = port_records.counters(data, "serve")
    if c is None or not c.get("serve.calls"):
        return None
    return c.get("serve.rows", 0) / c["serve.calls"]
