"""The work a scoring call needs, from the configuration's shapes at the valid
tokens, patches and crops of its rows: matmul operations for the whole
step's utilization, and operations and bytes per attention and W8A8 call for
their rooflines. Each family counts its own rows (``row_work`` in
``benchmark/families/<family>.py``) with the building blocks here. Padding, duplicated bucket rows and recomputation are not
counted: they are work the inputs do not need.

A ``Work`` sums rows. Each term is one kind of call repeated ``reps`` times
(once a layer): its operations and bytes summed over the rows of the device
call, its bound ``reps * max(ops / peak, bytes / HBM)``.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Dict, List

from . import peaks

BF16 = peaks.BF16_FLOPS
INT8 = peaks.INT8_OPS


class Work:
    def __init__(self):
        self.ideal_s = 0.0  # matmul operations over their peaks
        self.terms: Dict[str, List[float]] = defaultdict(lambda: [0.0, 0.0, BF16, 1])
        self.fixed: Dict[str, float] = {}  # bytes read once a call (weights)

    def mm(self, ops: float, peak: float = BF16) -> None:
        self.ideal_s += ops / peak

    def term(self, key: str, ops: float, nbytes: float, peak: float = BF16, reps: int = 1,
             fixed_bytes: float = 0.0) -> None:
        t = self.terms[key]
        t[0] += ops
        t[1] += nbytes
        t[2], t[3] = peak, reps
        if fixed_bytes:
            self.fixed[key] = fixed_bytes

    def bound_s(self, prefix: str) -> float:
        return sum(r * max(o / p, (b + self.fixed.get(k, 0.0)) / peaks.HBM_BYTES)
                   for k, (o, b, p, r) in self.terms.items() if k.startswith(prefix))

    def __iadd__(self, other: "Work") -> "Work":
        self.ideal_s += other.ideal_s
        for k, (o, b, p, r) in other.terms.items():
            self.term(k, o, b, p, r)
        self.fixed.update(other.fixed)
        return self


def attn(w: Work, key: str, heads: int, kv_heads: int, d: int, n: int, layers: int,
         causal: bool, io_bytes: float) -> None:
    """One kind of attention call, once a layer: its operations (at the valid
    pairs, causal or not) and its bytes in and out."""
    pairs = n * (n + 1) / 2 if causal else n * n
    ops = 4 * heads * d * pairs
    w.mm(ops * layers)
    w.term(key, ops, io_bytes, BF16, layers)
