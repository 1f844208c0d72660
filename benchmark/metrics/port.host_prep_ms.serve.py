"""Host milliseconds an image of a request's preparation in serving: the
port's ``serve.prep`` (chat template, base64 and PNG decode, processor) over
the images of the traced part's requests."""

from benchmark.harness import port_records


def read(data):
    recs = port_records.spans(data, "serve", "serve.prep")
    if recs is None:
        return None
    images = sum(r.attrs.get("images", 0) for r in recs)
    return 1e3 * sum(r.seconds for r in recs) / images if images else None
