"""Milliseconds batch evaluation's consumer, the thread that drives the card,
waits for the loader's next batch, averaged over the traced part's
batches: the port's ``loader.wait``.

``SPANS`` registers, with no entries, every span of the port that may hold a
launch (``profiling.NAMES``, ``launches``): the port's spans are host
operations with no device-side range, and should one become a user
annotation, the summarizer reads its range as a span, not as a kernel."""

from benchmark.harness import port_records

SPANS = {"serve.call": [], "serve.collate": [], "serve.step": [], "eval.step": [],
         "loader.device_put": [], "attn": [], "w8a8": []}


def read(data):
    return port_records.mean_ms(data, "eval", "loader.wait")
