"""Scoring entry point (``llava_reward_tpu/evalx/adaptor.py:201-233``).

``RewardAdaptor`` holds the configs, the param tree and the device;
``make_score_fn`` returns the function that answers scoring requests,
memoised per ``(attn_impl, training)`` as in the JAX package.
``model_type`` is ``"phi3v"`` or ``"qwen"``; a qwen tree may be in the
fused-projection layout (``models/qwen25_vl.fuse_decoder_projections``,
as ``load_reward_adaptor`` leaves it) or the separate one.
``load_reward_adaptor`` (base weights + LoRA merge + artifact heads) waits
for ROADMAP slice 3.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Dict, Tuple, Union

import torch

from ..core.config import Phi3VConfig, Qwen25VLConfig, RewardConfig
from ..core.device import DEFAULT_DEVICE, resolve_device
from ..reward.model import RewardBatch, reward_forward


def batch_to_device(batch: RewardBatch, device: torch.device) -> RewardBatch:
    """Numpy / tensor batch fields -> tensors on ``device``."""
    return RewardBatch(*[None if x is None else torch.as_tensor(x).to(device) for x in batch])


@dataclass
class RewardAdaptor:
    """Model + configs on one device; ``device`` defaults to ``"cuda"`` and
    raises where there is none."""

    cfg: Union[Phi3VConfig, Qwen25VLConfig]
    rcfg: RewardConfig
    params: dict  # {'backbone': ..., 'head': ...}
    model_type: str = "phi3v"
    device: Union[str, torch.device] = DEFAULT_DEVICE
    _score_fns: Dict[Tuple[str, bool], Callable] = field(default_factory=dict, repr=False)

    def __post_init__(self):
        self.device = resolve_device(self.device)
        want = {"phi3v": Phi3VConfig, "qwen": Qwen25VLConfig}.get(self.model_type)
        if want is None:
            raise NotImplementedError(
                f"model_type {self.model_type!r}: LLaVA-NeXT is ROADMAP slice 6"
            )
        if not isinstance(self.cfg, want):
            raise ValueError(f"model_type {self.model_type!r} takes a {want.__name__}, "
                             f"got {type(self.cfg).__name__}")

    def make_score_fn(self, attn_impl: str = "auto", training: bool = False):
        """``score(params, batch) -> (B, value_head_dim)`` rewards. Batch
        fields may be numpy arrays or tensors; they move to the adaptor's
        device."""
        key = (attn_impl, training)
        if key in self._score_fns:
            return self._score_fns[key]
        cfg, rcfg, device = self.cfg, self.rcfg, self.device

        @torch.inference_mode()
        def score(params: dict, batch: RewardBatch) -> torch.Tensor:
            return reward_forward(
                params, cfg, rcfg, batch_to_device(batch, device),
                training=training, attn_impl=attn_impl,
            ).reward

        self._score_fns[key] = score
        return score
