"""The share of serving's traced part in which the batcher waited with nothing
to run: the port's ``serve.wait`` (the blocked get and the coalescing
window between two device calls) over the traced part's wall time."""

from benchmark.harness import port_records


def read(data):
    recs = port_records.spans(data, "serve", "serve.wait")
    if recs is None:
        return None
    return 100.0 * sum(r.seconds for r in recs) / data["trace"]["window_s"]
