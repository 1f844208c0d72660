"""Host batches to device batches (``llava_reward_tpu/preprocess/collate.py``):
``collate_qwen_samples`` and ``to_reward_batch``. The phi3v collator and its
u8 crop-bank paths arrive with the host data path (ROADMAP A8a)."""

from __future__ import annotations

import dataclasses
from typing import Any, Mapping, Sequence

import numpy as np
import torch

from ..core.device import DEFAULT_DEVICE, resolve_device
from ..reward.model import RewardBatch
from .qwen_vision import OPENAI_CLIP_MEAN, OPENAI_CLIP_STD

# fields of the JAX package's RewardBatch for the phi3v device-pixel path
_LATER = ("crop_grid", "resize_tabs")


def _host_norm(p: np.ndarray, valid: np.ndarray) -> np.ndarray:
    """u8 patches -> CLIP-normalised f32, pad slots zero (``collate.py:376-383``,
    the normalisation ``vision_forward`` applies on the device)."""
    rep = p.shape[-1] // 3
    mean, std = np.repeat(OPENAI_CLIP_MEAN, rep), np.repeat(OPENAI_CLIP_STD, rep)
    out = (p.astype(np.float32) / 255.0 - mean) / std
    return out * (valid != 0)[:, None]


def collate_qwen_samples(
    samples: Sequence,  # QwenProcessedSample
    seq_len: int,
    pad_token_id: int,
    patch_budget: int,
    unit_budget: int,
) -> dict:
    """Left-pad the token streams; right-pad the windowed patch arrays to the
    static (patch_budget, unit_budget) (``collate.py:345-429``). M-RoPE
    positions are padded with 1 on the left (pad positions never attend).
    A batch that mixes u8 and f32 patches is normalised to f32 on the host."""
    B = len(samples)
    input_ids = np.full((B, seq_len), pad_token_id, dtype=np.int32)
    attention_mask = np.zeros((B, seq_len), dtype=np.int32)
    splice_idx = np.full((B, seq_len), -1, dtype=np.int32)
    position_ids = np.ones((3, B, seq_len), dtype=np.int32)

    has_image = any(s.patches is not None for s in samples)
    patches = patch_valid = rot_pos = unit_gather = num_img_tokens = None
    if has_image:
        dtypes = {s.patches.dtype for s in samples if s.patches is not None}
        if len(dtypes) > 1:
            samples = [
                dataclasses.replace(s, patches=_host_norm(s.patches, s.patch_valid))
                if s.patches is not None and s.patches.dtype == np.uint8
                else s
                for s in samples
            ]
        ref = next(s for s in samples if s.patches is not None)
        patches = np.zeros((B, patch_budget, ref.patches.shape[-1]), ref.patches.dtype)
        patch_valid = np.zeros((B, patch_budget), np.int32)  # segment ids, 0 = pad
        rot_pos = np.zeros((B, patch_budget, 2), np.int32)
        unit_gather = np.zeros((B, unit_budget), np.int32)
        num_img_tokens = np.zeros((B,), np.int32)

    for b, s in enumerate(samples):
        ids = s.input_ids[:seq_len]
        n = ids.shape[0]
        input_ids[b, seq_len - n :] = ids
        attention_mask[b, seq_len - n :] = s.attention_mask[:seq_len]
        splice_idx[b, seq_len - n :] = s.splice_idx[:seq_len]
        position_ids[:, b, seq_len - n :] = s.position_ids[:, :seq_len]
        if has_image and s.patches is not None:
            p = s.patches.shape[0]
            if p > patch_budget:
                raise ValueError(f"patches {p} exceed budget {patch_budget}")
            patches[b, :p] = s.patches
            patch_valid[b, :p] = s.patch_valid
            rot_pos[b, :p] = s.rot_pos
            u = s.unit_gather.shape[0]
            if u > unit_budget:
                raise ValueError(f"units {u} exceed budget {unit_budget}")
            unit_gather[b, :u] = s.unit_gather
            num_img_tokens[b] = s.num_img_tokens

    return dict(
        input_ids=input_ids, attention_mask=attention_mask, splice_idx=splice_idx,
        position_ids=position_ids, pixel_values=patches, patch_valid=patch_valid,
        rot_pos=rot_pos, unit_gather=unit_gather, num_img_tokens=num_img_tokens,
        img_gather_idx=None,
    )


def _put(x: Any, dev: torch.device):
    if x is None:
        return None
    t = torch.from_numpy(np.ascontiguousarray(x)) if isinstance(x, np.ndarray) else x
    return t.to(dev, non_blocking=True)


def to_reward_batch(batch: Mapping, device=DEFAULT_DEVICE) -> RewardBatch:
    """Numpy (or tensor) batch fields -> ``RewardBatch`` on ``device``
    (``collate.py:432-449``). The phi3v device-pixel fields raise until
    their slice is ported."""
    for name in _LATER:
        if batch.get(name) is not None:
            raise NotImplementedError(
                f"batch field {name!r} belongs to the phi3v device-pixel path (ROADMAP A8b)"
            )
    dev = resolve_device(device)
    return RewardBatch(
        input_ids=_put(batch["input_ids"], dev),
        attention_mask=_put(batch["attention_mask"], dev),
        pixel_values=_put(batch["pixel_values"], dev),
        img_gather_idx=_put(batch.get("img_gather_idx"), dev),
        splice_idx=_put(batch["splice_idx"], dev),
        num_img_tokens=_put(batch["num_img_tokens"], dev),
        position_ids=_put(batch.get("position_ids"), dev),
        patch_valid=_put(batch.get("patch_valid"), dev),
        rot_pos=_put(batch.get("rot_pos"), dev),
        unit_gather=_put(batch.get("unit_gather"), dev),
    )
