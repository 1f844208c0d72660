"""Share of the card's normalised rows in batch evaluation's traced part that
the norm kernel carried: the port's counters ``norm.kernel_rows`` over
``norm.kernel_rows`` + ``norm.plain_rows`` (rows of card tensors normalised by
the kernel and by the plain code, ``ops/norms.py``)."""

from benchmark.harness import port_records


def read(data):
    c = port_records.counters(data, "eval")
    if c is None:
        return None
    kernel, plain = c.get("norm.kernel_rows", 0), c.get("norm.plain_rows", 0)
    if kernel + plain == 0:
        return None
    return 100.0 * kernel / (kernel + plain)
