"""Value head and reward read-out (``llava_reward_tpu/reward/heads.py``)."""

from __future__ import annotations

import torch

from ..core.device import DEFAULT_DEVICE, resolve_device


def init_value_head(
    hidden_size: int,
    value_head_dim: int,
    generator: torch.Generator,
    dtype: torch.dtype = torch.float32,
    device=DEFAULT_DEVICE,
) -> dict:
    """nn.Linear(hidden, dim, bias=False) with init normal(0, 1/(h+1))."""
    dev = resolve_device(device)
    w = torch.randn(hidden_size, value_head_dim, generator=generator, device=dev,
                    dtype=torch.float32) / (hidden_size + 1)
    return {"kernel": w.to(dtype)}


def apply_value_head(head: dict, hidden: torch.Tensor) -> torch.Tensor:
    return hidden @ head["kernel"]


def eos_index_from_mask(attention_mask: torch.Tensor) -> torch.Tensor:
    """Index of the last valid (rightmost 1) position per row:
    S - 1 - argmax(fliplr(mask))."""
    S = attention_mask.shape[-1]
    flipped = torch.flip(attention_mask.to(torch.int32), dims=[-1])
    return S - 1 - torch.argmax(flipped, dim=-1)


def readout(
    values: torch.Tensor,  # (B, S, D) or (B, D) if already pooled
    attention_mask: torch.Tensor,
    *,
    training: bool,
    mean_pooled: bool,
) -> torch.Tensor:
    """training (left pad) -> values[:, -1]; eval -> gather at the EOS
    index; mean-pooled values pass through."""
    if mean_pooled:
        return values
    if training:
        return values[:, -1, :]
    idx = eos_index_from_mask(attention_mask)
    return values[torch.arange(values.shape[0], device=values.device), idx]


def masked_mean_pool(hidden: torch.Tensor, attention_mask: torch.Tensor) -> torch.Tensor:
    mask = attention_mask.to(hidden.dtype)[..., None]
    s = torch.sum(hidden * mask, dim=1)
    n = torch.clamp(torch.sum(mask, dim=1), min=1e-8)
    return s / n
