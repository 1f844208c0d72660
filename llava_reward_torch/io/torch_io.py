"""Checkpoint files on the host (the port's own copy of
``llava_reward_tpu/io/torch_io.py``).

Reads and writes the reference's on-disk formats: single or sharded
``pytorch_model*.bin`` (torch.save zip) and ``*.safetensors``. The state
dicts hold torch tensors on the CPU in their stored dtype: bf16 stays bf16
(the JAX package widens it to f32 numpy, which has no bf16).
"""

from __future__ import annotations

import json
import os
import re
from typing import Dict

import numpy as np
import torch


class TrackedStateDict(dict):
    """State dict that records reads, so loaders can report unconsumed keys.

    The reference relies on torch's strict ``load_state_dict`` semantics
    (eval/reward_adaptor_loader.py:46-63): a missing key raises with context,
    and ``check_fully_consumed`` flags keys the loader never read."""

    def __init__(self, sd):
        super().__init__(sd)
        self.consumed: set = set()

    def __getitem__(self, k):
        try:
            v = super().__getitem__(k)
        except KeyError:
            raise KeyError(
                f"state dict is missing required key {k!r} (checkpoint/config "
                "mismatch: verify the base checkpoint matches the model config)"
            ) from None
        self.consumed.add(k)
        return v


# buffers some transformers versions persist but no loader consumes
_IGNORE_PATTERNS = (
    r"\.rotary_emb\.inv_freq$",
    r"\.position_ids$",
    r"\.masked_bias$",
)

# reward-head keys owned by io/artifact.py, not the backbone loaders: in the
# full-checkpoint mode (batch_inference_rm_ft_phi.py:28-55) they live in the
# SAME pytorch_model.bin as the base weights, so the base-checkpoint strict
# check must not flag them there (a genuine base checkpoint never holds them).
REWARD_HEAD_PATTERNS = (
    r"(^|\.)value_head\.",
    r"(^|\.)W_q\.",
    r"(^|\.)W_k\.",
    r"(^|\.)W_v\.",
    r"(^|\.)ca_layernorm\.",
    r"(^|\.)prompt_head\.",
)


def check_fully_consumed(sd, *, strict: bool = True, what: str = "checkpoint",
                         ignore: tuple = ()) -> list:
    """Report state-dict keys the loader never read (key drift drops weights
    silently). ``strict=True`` raises; otherwise logs a warning. Returns the
    unconsumed keys."""
    if not isinstance(sd, TrackedStateDict):
        return []
    pats = [re.compile(p) for p in _IGNORE_PATTERNS + tuple(ignore)]
    extra = sorted(k for k in sd if k not in sd.consumed and not any(p.search(k) for p in pats))
    if not extra:
        return []
    shown = ", ".join(extra[:12]) + (" ..." if len(extra) > 12 else "")
    msg = (
        f"{len(extra)} unconsumed key(s) loading {what}: [{shown}] — these "
        "weights would be silently dropped. Pass strict=False to downgrade "
        "this to a warning."
    )
    if strict:
        raise ValueError(msg)
    from ..core.logging import init_logger

    init_logger(__name__).warning(msg)
    return extra


def _shards(path: str, index: str):
    with open(os.path.join(path, index)) as f:
        return sorted(set(json.load(f)["weight_map"].values()))


def load_torch_state_dict(path: str) -> Dict[str, torch.Tensor]:
    """A model dir (HF layout, shard index files included) or one
    .bin / .safetensors file -> {key: CPU tensor}."""
    if os.path.isdir(path):
        for index in ("model.safetensors.index.json", "pytorch_model.bin.index.json"):
            if os.path.exists(os.path.join(path, index)):
                out: Dict[str, torch.Tensor] = {}
                for shard in _shards(path, index):
                    out.update(load_torch_state_dict(os.path.join(path, shard)))
                return out
        for name in ("model.safetensors", "pytorch_model.bin"):
            p = os.path.join(path, name)
            if os.path.exists(p):
                return load_torch_state_dict(p)
        raise FileNotFoundError(f"no checkpoint found under {path}")

    if path.endswith(".safetensors"):
        from safetensors.torch import load_file

        sd = load_file(path)
    else:
        sd = torch.load(path, map_location="cpu", weights_only=True)
    return {k: v.detach() for k, v in sd.items()}


def save_torch_state_dict(sd: Dict[str, object], path: str, dtype=None) -> None:
    """Write {key: tensor or numpy array} as a torch .bin (the reference's
    artifact format, deepspeed.py:383). ``dtype``: an optional torch dtype
    (e.g. torch.bfloat16) for every value."""
    out = {}
    for k, v in sd.items():
        t = v.detach().cpu() if isinstance(v, torch.Tensor) else torch.from_numpy(np.array(v))
        if dtype is not None:
            t = t.to(dtype)
        out[k] = t.contiguous()
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    torch.save(out, path)
