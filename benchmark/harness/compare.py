"""The comparison that decides ``correct``: the rewards the timed path
produced against the plain reference's rewards of the same rows.

With random weights every rounding in the model is amplified on its way to
the reward, by a factor that depends on the seed's weights and inputs:
bf16's 0.1-0.4 % an op reaches 1-11 % of the reward at full depth. So the
gaps are stated against the reference's rewards, and also against the
reference's own move under the cell's rounding: the same reference, every
op rounded to bfloat16 (``reference.common.rounding``), on the same rows.

- ``reward_gap``: the widest gap of one reward, as a share of the reference
  rewards' root mean square over the sampled rows;
- ``reward_rms_gap``: the root mean square of the gaps, the same share;
- ``reward_gap_bf16_units``: ``reward_rms_gap`` over the bf16-rounded
  reference's own ``reward_rms_gap``: about 1 for a program computed in the
  cell's precision, several times that for one computed below it.

A cell compares the numbers its limits file names. Its control is the
same reference with every op rounded to bfloat16 and its products one
precision below the cell's (``reference.common.control``, the traffic
file's ``control``): the limits have to catch it."""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np


def _gaps(got: np.ndarray, ref: np.ndarray) -> Dict[str, float]:
    scale = float(np.sqrt(np.mean(ref ** 2)))
    d = np.abs(got - ref)
    return {"reward_gap": float(d.max() / scale),
            "reward_rms_gap": float(np.sqrt(np.mean(d ** 2)) / scale)}


def reward_gaps(got, ref, ref_low: Optional[np.ndarray] = None) -> Dict[str, float]:
    """``got``, ``ref`` and ``ref_low``: (rows..., dim) arrays of the same rows;
    inf when the program gave no reward for one of them or a non-finite one."""
    ref = np.asarray(ref, np.float64)
    names = ["reward_gap", "reward_rms_gap"] + (["reward_gap_bf16_units"]
                                                if ref_low is not None else [])
    if got is None:
        return {k: float("inf") for k in names}
    got = np.asarray(got, np.float64)
    if got.shape != ref.shape or not np.isfinite(got).all():
        return {k: float("inf") for k in names}
    out = _gaps(got, ref)
    if ref_low is not None:
        noise = _gaps(np.asarray(ref_low, np.float64), ref)["reward_rms_gap"]
        out["bf16_reference_rms_gap"] = noise
        out["reward_gap_bf16_units"] = out["reward_rms_gap"] / noise if noise > 0 else float(
            "inf")
    return out


def checks(gaps: Dict[str, float], limits: dict) -> Dict[str, dict]:
    """Each number the limits name, beside its limit."""
    return {k: {"value": gaps[k], "limit": limits[k]} for k in gaps if k in limits}


def within(checked: Dict[str, dict]) -> bool:
    return all(c["value"] <= c["limit"] for c in checked.values())


def reference_variants(controls: Optional[dict] = None):
    """(name, rounding dtype, control schemes) of each reference a run
    computes: the float32 reference, the bf16-rounded yardstick and, for
    ``control.py``, each control (``controls``: name -> schemes)."""
    import torch

    out = [("fp32", None, {}), ("bf16", torch.bfloat16, {})]
    return out + [(k, torch.bfloat16, v) for k, v in (controls or {}).items()]


def control_gaps(ref: dict, limits: dict, controls: Optional[dict]):
    """Each control's numbers against the same reference and yardstick, and
    whether the cell's limits catch it (``caught``); None without one."""
    if not controls:
        return None
    out = {}
    for k in controls:
        gaps = reward_gaps(ref[k], ref["fp32"], ref["bf16"])
        out[k] = dict(gaps, caught=not within(checks(gaps, limits)))
    return out
