"""Host milliseconds an image in the service's processor call (smart
resize, patches, the windowed layout) in serving, averaged over the
window's images."""


def read(data):
    if data is None or data.get("role") != "serve":
        return None
    return data.get("host_prep_ms")
