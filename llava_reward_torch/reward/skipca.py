"""SkipCA: single-head cross-attention from decoder hidden states back to
the vision embedding, with residual + RMSNorm
(``llava_reward_tpu/reward/skipca.py``).

phi3v mode applies no mask over zero-padded vision slots up to the batch
max image-token count (their scores are exactly 0 but still take softmax
weight); columns at or beyond ``batch_max`` never existed in the reference
and are masked with -inf. qwen mode masks each sample's invalid slots with
the reference's finite -1e4 fill (``skipca.py:71-73``).
"""

from __future__ import annotations

from typing import Optional

import torch

from ..core.device import DEFAULT_DEVICE, resolve_device
from ..ops.linear import einsum, mm
from ..ops.norms import rms_norm


def init_params(
    hidden_size: int,
    generator: torch.Generator,
    dtype: torch.dtype = torch.float32,
    device=DEFAULT_DEVICE,
) -> dict:
    """W_q/W_k/W_v ~ normal(0, 1/(hidden+1)), ca_layernorm weight ones."""
    dev = resolve_device(device)
    std = 1.0 / (hidden_size + 1)

    def w():
        return (torch.randn(hidden_size, hidden_size, generator=generator, device=dev,
                            dtype=torch.float32) * std).to(dtype)

    return {
        "W_q": {"kernel": w()},
        "W_k": {"kernel": w()},
        "W_v": {"kernel": w()},
        "ca_layernorm": {"weight": torch.ones(hidden_size, device=dev, dtype=dtype)},
    }


def apply(
    params: dict,
    hidden: torch.Tensor,  # (B, S, H)
    vision: torch.Tensor,  # (B, T_img, H) zero on invalid slots
    num_img_tokens: torch.Tensor,  # (B,)
    *,
    rms_eps: float = 1e-5,
    mode: str = "phi3v",
    batch_max: Optional[torch.Tensor] = None,  # () or (B,) zero-pad width per sample
) -> torch.Tensor:
    if mode not in ("phi3v", "qwen"):
        raise ValueError(f"unknown SkipCA mode {mode!r}")
    H = vision.shape[-1]
    q = mm(hidden, params["W_q"]["kernel"])
    k = mm(vision, params["W_k"]["kernel"])
    v = mm(vision, params["W_v"]["kernel"])
    # fp32 scores of the (bf16) projections, as preferred_element_type=f32
    scores = torch.einsum("bsh,bth->bst", q.float(), k.float()) / torch.sqrt(
        torch.tensor(float(H), device=hidden.device)
    )
    slot = torch.arange(vision.shape[1], device=hidden.device)[None, :]
    if mode == "phi3v":
        if batch_max is None:
            batch_max = torch.max(num_img_tokens)
        batch_max = torch.as_tensor(batch_max, device=hidden.device).expand(vision.shape[0])
        invalid = slot >= batch_max[:, None]
        scores = scores.masked_fill(invalid[:, None, :], float("-inf"))
    else:
        invalid = slot >= num_img_tokens[:, None]
        scores = scores.masked_fill(invalid[:, None, :], -1e4)
    probs = torch.softmax(scores, dim=-1).to(hidden.dtype)
    out = einsum("bst,bth->bsh", probs, v)
    return rms_norm(hidden + out, params["ca_layernorm"]["weight"], rms_eps)
