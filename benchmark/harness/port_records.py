"""What the port recorded itself in the traced part (``utils/profiling`` in
``llava_reward_torch``: its spans and counters of the latest profiling
session, which is the traced part's), for the metrics that read them. Each
gives None where the run had no traced part, or where the port records no
such thing (a commit before its spans), so a metric reading it is left out.
"""

from __future__ import annotations

from typing import Dict, List, Optional


def _session(data: Optional[dict], role: str):
    if data is None or data.get("role") != role or not data["trace"].get("window_s"):
        return None  # no traced part: the latest session would be a set-up call's
    from llava_reward_torch.utils import profiling

    return profiling.session() if hasattr(profiling, "session") else None


def spans(data: Optional[dict], role: str, name: str) -> Optional[List]:
    """The session's records of span ``name``, or None if there are none."""
    s = _session(data, role)
    recs = s.named(name) if s is not None else []
    return recs or None


def counters(data: Optional[dict], role: str) -> Optional[Dict[str, int]]:
    s = _session(data, role)
    return dict(s.counts) if s is not None and s.counts else None


def mean_ms(data: Optional[dict], role: str, name: str) -> Optional[float]:
    recs = spans(data, role, name)
    return None if recs is None else 1e3 * sum(r.seconds for r in recs) / len(recs)
