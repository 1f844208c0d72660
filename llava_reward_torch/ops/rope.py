"""Rotary position embeddings: base, LongRoPE ("su") and yarn scaling.

Counterpart of ``llava_reward_tpu/ops/rope.py:23-96``:
- frequencies and trig in fp32, cast to the compute dtype;
- su/yarn pick the long factors iff ``max(position_ids)+1 >
  original_max_position_embeddings`` (:43-44);
- su scaling factor sqrt(1 + log(scale)/log(orig_max)) when
  max_pos > orig_max, yarn 0.1*log(scale)+1;
- emb = concat(freqs, freqs); rotate_half pairs dim i with dim i+d/2.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from ..core.config import DecoderConfig


def compute_rope_cos_sin(
    position_ids: torch.Tensor,  # (B, S) integer
    head_dim: int,
    base: float = 10000.0,
    dtype: torch.dtype = torch.bfloat16,
    scaling: Optional[object] = None,  # RopeScalingConfig
    max_position_embeddings: int = 131072,
    original_max_position_embeddings: int = 4096,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns cos, sin of shape (B, S, head_dim), in ``dtype``."""
    dev = position_ids.device
    half = head_dim // 2
    exponent = torch.arange(0, half, dtype=torch.float32, device=dev) / (head_dim / 2.0)
    pos = position_ids.float()
    powed = torch.pow(torch.tensor(base, dtype=torch.float32, device=dev), exponent)

    if scaling is None:
        inv_freq = 1.0 / powed
        scaling_factor = 1.0
    else:
        short = torch.tensor(scaling.short_factor, dtype=torch.float32, device=dev)
        long = torch.tensor(scaling.long_factor, dtype=torch.float32, device=dev)
        seq_len = position_ids.max() + 1
        ext = torch.where(seq_len > original_max_position_embeddings, long, short)
        inv_freq = 1.0 / (ext * powed)
        scale = max_position_embeddings / original_max_position_embeddings
        if scale <= 1.0:
            scaling_factor = 1.0
        elif scaling.rope_type == "su":
            scaling_factor = math.sqrt(
                1.0 + math.log(scale) / math.log(original_max_position_embeddings)
            )
        elif scaling.rope_type == "yarn":
            scaling_factor = 0.1 * math.log(scale) + 1.0
        else:
            raise ValueError(f"unknown rope scaling type {scaling.rope_type}")

    freqs = pos[..., None] * inv_freq[None, None, :]  # (B, S, half)
    emb = torch.cat([freqs, freqs], dim=-1)
    cos = torch.cos(emb) * scaling_factor
    sin = torch.sin(emb) * scaling_factor
    return cos.to(dtype), sin.to(dtype)


def rope_cos_sin_for_config(
    position_ids: torch.Tensor, cfg: DecoderConfig, dtype: torch.dtype = torch.bfloat16
) -> Tuple[torch.Tensor, torch.Tensor]:
    return compute_rope_cos_sin(
        position_ids,
        cfg.head_dim,
        base=cfg.rope_theta,
        dtype=dtype,
        scaling=cfg.rope_scaling,
        max_position_embeddings=cfg.max_position_embeddings,
        original_max_position_embeddings=cfg.original_max_position_embeddings,
    )


def rotate_half(x: torch.Tensor) -> torch.Tensor:
    x1, x2 = torch.chunk(x, 2, dim=-1)
    return torch.cat([-x2, x1], dim=-1)


def apply_rotary(
    q: torch.Tensor,  # (B, S, H, D)
    k: torch.Tensor,  # (B, S, Hk, D)
    cos: torch.Tensor,  # (B, S, D)
    sin: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """RoPE with heads on axis 2 (B, S, H, D layout)."""
    c = cos[:, :, None, :]
    s = sin[:, :, None, :]
    return q * c + rotate_half(q) * s, k * c + rotate_half(k) * s
