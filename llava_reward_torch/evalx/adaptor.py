"""Scoring entry point (``llava_reward_tpu/evalx/adaptor.py:201-233``).

``RewardAdaptor`` holds the configs, the param tree and the device;
``make_score_fn`` returns the function that answers scoring requests,
memoised per ``(attn_impl, training)`` as in the JAX package.
``model_type`` is ``"phi3v"`` or ``"qwen"``; a qwen tree may be in the
fused-projection layout (``models/qwen25_vl.fuse_decoder_projections``,
as ``load_reward_adaptor`` leaves it) or the separate one.
``merge_for_scoring`` is the tail of the JAX package's
``load_reward_adaptor`` (``adaptor.py:380-489``): a trained LoRA folded into
the decoder, a trained projector put in its slot, and for qwen the
projections fused, so that the scoring route reads what training wrote.
Loading base weights from a checkpoint directory waits for ROADMAP A8b.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Dict, Optional, Tuple, Union

import torch

from ..core.config import Phi3VConfig, Qwen25VLConfig, RewardConfig
from ..core.device import DEFAULT_DEVICE, resolve_device
from ..lora.lora import merge_lora
from ..models.qwen25_vl import fuse_decoder_projections
from ..reward.model import RewardBatch, reward_forward
from ..train.optim import tree_map


def batch_to_device(batch: RewardBatch, device: torch.device) -> RewardBatch:
    """Numpy / tensor batch fields -> tensors on ``device``."""
    return RewardBatch(*[None if x is None else torch.as_tensor(x).to(device) for x in batch])


def merge_for_scoring(backbone: dict, model_type: str, lora: Optional[dict] = None,
                      projector: Optional[dict] = None) -> dict:
    """The backbone tree a trained artifact scores with: ``lora`` (a stacked
    tree, e.g. ``peft_state_to_stacked`` of the artifact's adapter) merged
    into the decoder's layers in their dtype, ``projector`` (phi3v's
    ``img_projection`` or qwen's merger) in its slot, and a qwen decoder in
    the fused inference layout, which takes no adapters and so comes after
    the merge. The input tree is not modified."""
    vis, dec = {"phi3v": ("vision", "decoder"), "qwen": ("visual", "text")}[model_type]
    out = dict(backbone)
    layers = out[dec]["layers"]
    if lora is not None:
        layers = merge_lora(layers, lora)
    if model_type == "qwen":
        layers = fuse_decoder_projections(layers)
    out[dec] = {**out[dec], "layers": layers}
    if projector is not None:
        slot = "img_projection" if model_type == "phi3v" else "merger"
        like = out[vis][slot]["fc1"]["kernel"]  # the slot's device and dtype
        out[vis] = {**out[vis], slot: tree_map(
            lambda t: t.to(device=like.device, dtype=like.dtype), projector)}
    return out


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
