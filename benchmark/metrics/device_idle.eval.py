"""The share of the traced window of batch evaluation with no kernel running
on the card."""


def read(data):
    if data is None or data.get("role") != "eval":
        return None
    t = data["trace"]
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
