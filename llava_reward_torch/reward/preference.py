"""Preference probability from a (chosen, rejected) reward pair
(``llava_reward_tpu/reward/preference.py``)."""

from __future__ import annotations

import torch


def preference_prob(
    chosen_rewards: torch.Tensor,  # (B, D)
    reject_rewards: torch.Tensor,  # (B, D)
    *,
    is_general_preference: bool,
    value_head_dim: int,
    tau: float,
) -> torch.Tensor:
    """P(chosen > rejected). GPM dim-2 uses the skew product
    sigma((c0 r1 - c1 r0)/tau); otherwise BT sigma((rc - rr)/tau)."""
    if is_general_preference and value_head_dim == 2:
        prod = (
            chosen_rewards[:, 0] * reject_rewards[:, 1]
            - chosen_rewards[:, 1] * reject_rewards[:, 0]
        )
        return torch.sigmoid(prod / tau)
    return torch.sigmoid((chosen_rewards - reject_rewards) / tau)[..., 0]
