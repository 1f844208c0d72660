"""The whole scoring step's share of the card's peak in batch evaluation:
the matmul operations the window's rows need (valid tokens, patches and
crops; bf16 at 989 TFLOP/s, W8A8 projections at 1979 TOP/s) over the
window's wall time."""


def count(work):
    """A device call's matmul operations over their peaks, in seconds."""
    return work.ideal_s


def read(data):
    if data is None or data.get("role") != "eval" or not data.get("wall_s"):
        return None
    ideal = data.get("count", {}).get("window", 0.0)
    return 100.0 * ideal / data["wall_s"] if ideal > 0 else None
