"""Share of the image patches computed in serving's traced part that the rows
carry: the port's counters ``serve.patches`` (patches with a nonzero segment
id) over ``serve.patches_padded`` (rows x the padded patches of each device
call)."""

from benchmark.harness import port_records


def read(data):
    c = port_records.counters(data, "serve")
    if c is None or not c.get("serve.patches_padded"):
        return None
    return 100.0 * c.get("serve.patches", 0) / c["serve.patches_padded"]
