"""Activation functions used by the backbones (``llava_reward_tpu/ops/activations.py``)."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    """CLIP's quick_gelu: x * sigmoid(1.702 x)."""
    return x * torch.sigmoid(1.702 * x)


def gelu(x: torch.Tensor) -> torch.Tensor:
    """Exact (erf) GELU, as the Phi3V img_projection MLP uses."""
    return F.gelu(x, approximate="none")


def silu(x: torch.Tensor) -> torch.Tensor:
    return F.silu(x)


ACT2FN = {
    "quick_gelu": quick_gelu,
    "gelu": gelu,
    "gelu_new": lambda x: F.gelu(x, approximate="tanh"),
    "silu": silu,
}
