"""Normalisation ops with fp32 internals (bf16 in/out).

Counterpart of ``llava_reward_tpu/ops/norms.py``. RMSNorm follows Phi-3's
cast order (``norms.py:13-18``): variance in fp32, rescale by
``1/sqrt(var+eps)``, cast back to the input dtype, THEN multiply by the
weight.
"""

from __future__ import annotations

import torch


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    dtype = x.dtype
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    xf = xf * torch.reciprocal(torch.sqrt(var + eps))
    return weight * xf.to(dtype)


def layer_norm(
    x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, eps: float = 1e-5
) -> torch.Tensor:
    """Standard LayerNorm (CLIP tower), fp32 internals."""
    dtype = x.dtype
    xf = x.float()
    mean = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.mean((xf - mean) ** 2, dim=-1, keepdim=True)
    xf = (xf - mean) * torch.reciprocal(torch.sqrt(var + eps))
    out = xf * weight.float() + bias.float()
    return out.to(dtype)
