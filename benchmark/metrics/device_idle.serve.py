"""The share of the traced window of serving with no kernel running
on the card."""


def read(data):
    if data is None or data.get("role") != "serve":
        return None
    t = data["trace"]
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
