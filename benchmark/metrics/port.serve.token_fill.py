"""Share of the tokens computed in serving's traced part that the rows carry:
the port's counters ``serve.tokens`` (valid tokens of the real rows) over
``serve.tokens_padded`` (rows x the padded length of each device call)."""

from benchmark.harness import port_records


def read(data):
    c = port_records.counters(data, "serve")
    if c is None or not c.get("serve.tokens_padded"):
        return None
    return 100.0 * c.get("serve.tokens", 0) / c["serve.tokens_padded"]
