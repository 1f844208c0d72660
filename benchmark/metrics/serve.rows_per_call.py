"""Rows of each device call of the window in serving, averaged: what the
batcher coalesced (the bucket's padding rows not counted)."""


def read(data):
    if data is None or data.get("role") != "serve":
        return None
    return data.get("rows_per_call")
