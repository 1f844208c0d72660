"""Milliseconds a request waits in serving's batcher, from its enqueue to the
start of the last device call that carries one of its rows, averaged over
the traced part's requests: the port's ``serve.queue``."""

from benchmark.harness import port_records


def read(data):
    return port_records.mean_ms(data, "serve", "serve.queue")
