"""Host batches to device batches (the port's own copy of
``llava_reward_tpu/preprocess/collate.py``).

The reference left-pads ids / masks to the batch max (zero_pad_sequences,
datasets/utils.py:5-13) and stacks pixel tensors (reward_dataset.py:137-202).
Here every batch pads to a FIXED ``seq_len``, so shapes repeat from step to
step; left padding keeps the training-mode ``values[:, -1]`` read-out and the
eval-mode EOS gather. The phi3v collator has three pixel forms: the host f32
bank, u8 crops with their grid (normalised and globally resized on the
device), and decoded u8 originals with bilinear tap tables (resized on the
device too). ``to_reward_batch`` puts a numpy batch on a device.
"""

from __future__ import annotations

import dataclasses
from typing import Any, List, Mapping, Optional, Sequence

import numpy as np
import torch

from ..core.device import DEFAULT_DEVICE, resolve_device
from ..ops.pixels import (_HALF, PRECISION_BITS, WOUT_MAX, build_hd_resize_tables,
                          taps_for_bucket)
from ..reward.model import RewardBatch
from .phi3v_processor import (ProcessedSample, build_img_gather_idx, host_bank_from_u8,
                              sample_from_src)
from .qwen_vision import OPENAI_CLIP_MEAN, OPENAI_CLIP_STD


class Batch(dict):
    """Numpy batch with attribute access; converted to RewardBatch on device."""

    __getattr__ = dict.__getitem__


CROP_BUCKETS = (5, 9, 13, 17)  # 1 global + {4, 8, 12, 16} crops


def collate_samples(
    samples: Sequence[ProcessedSample],
    seq_len: int,
    pad_token_id: int,
    img_token_budget: Optional[int] = None,
    crop_buckets: Optional[Sequence[int]] = CROP_BUCKETS,
) -> Batch:
    """Left-pad to ``seq_len`` (truncating from the right if too long, the
    reference's truncation_side='right') and stack.

    Crop bucketing (phi3v / llava): the reference pads every image to
    num_crops+1 crops (pad_to_max_num_crops_tensor, processing_phi3_v.py:
    128-136), so a 2x2 image runs the CLIP tower on 12 zero crops. Here the
    pixel batch shrinks to the smallest bucket >= the batch's real crop
    count; gather indices are rebuilt against the bucketed bank layout.
    A handful of buckets = a handful of batch shapes.
    """
    B = len(samples)
    input_ids = np.full((B, seq_len), pad_token_id, dtype=np.int32)
    attention_mask = np.zeros((B, seq_len), dtype=np.int32)
    splice_idx = np.full((B, seq_len), -1, dtype=np.int32)

    has_image = any(s.pixel_values is not None for s in samples)
    pixel_values = None
    img_gather_idx = None
    num_img_tokens = None
    crop_grid = None
    n_src = sum(
        1 for s in samples if getattr(s, "src_u8", None) is not None
    )
    if n_src:
        img_like = [
            s for s in samples
            if s.pixel_values is not None or getattr(s, "src_u8", None) is not None
        ]
        if n_src == len(img_like):
            return _collate_u8src(
                samples, seq_len, pad_token_id, img_token_budget, crop_buckets
            )
        # mixed (rare: some images fell back to host paths): host-resize the
        # device-resize samples — bit-identical, the device op matches PIL
        samples = [
            sample_from_src(s) if getattr(s, "src_u8", None) is not None else s
            for s in samples
        ]
        has_image = True
    if has_image:
        img_samples = [s for s in samples if s.pixel_values is not None]
        # llava samples have no crop_grid field (anyres keeps the f32 path)
        n_u8 = sum(
            1 for s in img_samples if getattr(s, "crop_grid", None) is not None
        )
        if 0 < n_u8 < len(img_samples):
            # mixed batch (rare: extreme-aspect fallback) -> everything f32
            samples = [
                dataclasses.replace(
                    s,
                    pixel_values=host_bank_from_u8(s.pixel_values, s.crop_grid),
                    crop_grid=None,
                )
                if s.pixel_values is not None
                and getattr(s, "crop_grid", None) is not None
                else s
                for s in samples
            ]
            n_u8 = 0
        if n_u8:
            return _collate_u8(
                samples, seq_len, pad_token_id, img_token_budget, crop_buckets
            )
        ref = next(s for s in samples if s.pixel_values is not None)
        budget = (
            img_token_budget
            if img_token_budget is not None
            else max(
                s.img_gather_idx.shape[0]
                for s in samples
                if s.img_gather_idx is not None
            )
        )
        crop_counts = [
            s.pixel_values.shape[0] for s in samples if s.pixel_values is not None
        ]
        full_nc = max(crop_counts)  # multi-image samples concatenate crops
        # bucketing only applies to single-image phi3v HD crops (image_size
        # is the padded HD size); llava anyres / multi-image keep full tiles
        is_phi3v = getattr(ref, "family", "phi3v") == "phi3v"
        uniform_single = len(set(crop_counts)) == 1 and full_nc == ref.pixel_values.shape[0]
        if crop_buckets and is_phi3v and uniform_single and full_nc in (17, *crop_buckets):
            real = max(
                (s.image_size[0] // 336) * (s.image_size[1] // 336) + 1
                for s in samples
                if s.pixel_values is not None
            )
            nc = min(
                (b for b in crop_buckets if b >= real), default=full_nc
            )
            nc = min(nc, full_nc)
        else:
            nc = full_nc
        pixel_values = np.zeros(
            (B, nc) + ref.pixel_values.shape[1:], dtype=np.float32
        )
        img_gather_idx = np.zeros((B, budget), dtype=np.int32)
        num_img_tokens = np.zeros((B,), dtype=np.int32)

    for b, s in enumerate(samples):
        ids = s.input_ids[:seq_len]
        n = ids.shape[0]
        input_ids[b, seq_len - n :] = ids
        attention_mask[b, seq_len - n :] = s.attention_mask[:seq_len]
        splice_idx[b, seq_len - n :] = s.splice_idx[:seq_len]
        if has_image and s.pixel_values is not None:
            pv = s.pixel_values[:nc]
            pixel_values[b, : pv.shape[0]] = pv  # crop-dim zero-pad is safe:
            # the bank's sentinel rows lead, so gather indices are invariant
            if nc != full_nc and pv.shape[0] == nc:
                # rebuild indices for the bucketed bank (stride = nc crops)
                h, w = s.image_size
                img_gather_idx[b] = build_img_gather_idx(
                    h // 336, w // 336, nc - 1, budget
                )
            else:
                g = s.img_gather_idx[:budget]
                img_gather_idx[b, : g.shape[0]] = g
            num_img_tokens[b] = s.num_img_tokens

    return Batch(
        input_ids=input_ids,
        attention_mask=attention_mask,
        splice_idx=splice_idx,
        pixel_values=pixel_values,
        img_gather_idx=img_gather_idx,
        num_img_tokens=num_img_tokens,
    )


U8_CROP_BUCKETS = (4, 8, 12, 16)  # crops only (the global view is computed on device)


def _collate_u8(
    samples: Sequence[ProcessedSample],
    seq_len: int,
    pad_token_id: int,
    img_token_budget: Optional[int] = None,
    crop_buckets: Optional[Sequence[int]] = CROP_BUCKETS,
) -> "Batch":
    """Device-preproc collation: uint8 crop bank + (hc, wc) grid per row;
    normalisation and the global bicubic happen on device
    (ops/pixels.prepare_pixel_bank). Same bucketing idea as the f32 path."""
    B = len(samples)
    input_ids = np.full((B, seq_len), pad_token_id, dtype=np.int32)
    attention_mask = np.zeros((B, seq_len), dtype=np.int32)
    splice_idx = np.full((B, seq_len), -1, dtype=np.int32)

    budget = (
        img_token_budget
        if img_token_budget is not None
        else max(
            s.img_gather_idx.shape[0] for s in samples if s.img_gather_idx is not None
        )
    )
    real = max(
        s.crop_grid[0] * s.crop_grid[1] for s in samples if s.pixel_values is not None
    )
    if crop_buckets:
        # f32 buckets count [global]+crops; the u8 bank holds crops only
        # (the global view is computed on device), hence the -1.
        buckets = tuple(sorted(b - 1 for b in crop_buckets))
        nc = min((b for b in buckets if b >= real), default=real)
    else:
        # crop_buckets=None means "stable shapes across requests" (server
        # path): a FIXED max-bucket bank, mirroring the f32 path's full
        # 17-crop layout, NOT batch-max, which would change the shape with
        # every grid size.
        nc = max(max(U8_CROP_BUCKETS), real)

    pixel_values = np.zeros((B, nc, 336, 336, 3), dtype=np.uint8)
    crop_grid = np.ones((B, 2), dtype=np.int32)
    img_gather_idx = np.zeros((B, budget), dtype=np.int32)
    num_img_tokens = np.zeros((B,), dtype=np.int32)

    for b, s in enumerate(samples):
        ids = s.input_ids[:seq_len]
        n = ids.shape[0]
        input_ids[b, seq_len - n :] = ids
        attention_mask[b, seq_len - n :] = s.attention_mask[:seq_len]
        splice_idx[b, seq_len - n :] = s.splice_idx[:seq_len]
        if s.pixel_values is None:
            continue
        hc, wc = s.crop_grid
        pixel_values[b, : hc * wc] = s.pixel_values
        crop_grid[b] = (hc, wc)
        # bank the model builds is [global, nc crops] -> same layout the
        # f32 bucketing produces, so indices rebuild against nc crops
        img_gather_idx[b] = build_img_gather_idx(hc, wc, nc, budget)
        num_img_tokens[b] = s.num_img_tokens

    return Batch(
        input_ids=input_ids,
        attention_mask=attention_mask,
        splice_idx=splice_idx,
        pixel_values=pixel_values,
        img_gather_idx=img_gather_idx,
        num_img_tokens=num_img_tokens,
        crop_grid=crop_grid,
    )


SRC_BUCKETS = (672, 1008, 1344, 2016, 2688)  # square u8-source buckets


def _collate_u8src(
    samples: Sequence[ProcessedSample],
    seq_len: int,
    pad_token_id: int,
    img_token_budget: Optional[int] = None,
    crop_buckets: Optional[Sequence[int]] = CROP_BUCKETS,
) -> "Batch":
    """Device-RESIZE collation (LRT_DEVICE_RESIZE=1): the batch carries the
    decoded uint8 originals (landscape-oriented, padded into a static square
    bucket) + per-sample bilinear tap tables; HD resize, white-pad, crop
    split, normalisation and the global bicubic ALL run on device
    (ops/pixels.hd_resize_u8_bank + prepare_pixel_bank).

    ``crop_buckets=None`` means "stable shapes across requests" (server
    path, evalx/server.py): pin the crop bank, SRC bucket and tap count to
    their maxima so every request has ONE shape per batch size,
    mirroring the f32/_collate_u8 contract."""
    B = len(samples)
    input_ids = np.full((B, seq_len), pad_token_id, dtype=np.int32)
    attention_mask = np.zeros((B, seq_len), dtype=np.int32)
    splice_idx = np.full((B, seq_len), -1, dtype=np.int32)

    img_samples = [s for s in samples if s.src_u8 is not None]
    budget = (
        img_token_budget
        if img_token_budget is not None
        else max(s.img_gather_idx.shape[0] for s in img_samples)
    )
    real = max(s.crop_grid[0] * s.crop_grid[1] for s in img_samples)
    edge = max(max(s.src_u8.shape[:2]) for s in img_samples)
    if crop_buckets:
        # f32 buckets count [global]+crops; the u8 bank holds crops only
        buckets = tuple(sorted(b - 1 for b in crop_buckets))
        nc = min((b for b in buckets if b >= real), default=real)
        bucket = min((b for b in SRC_BUCKETS if b >= edge), default=edge)
    else:
        # stable-shapes contract: max bucket everywhere -> one shape
        nc = max(max(U8_CROP_BUCKETS), real)
        bucket = max(max(SRC_BUCKETS), edge)
    k = taps_for_bucket(bucket)

    src = np.zeros((B, bucket, bucket, 3), dtype=np.uint8)
    crop_grid = np.ones((B, 2), dtype=np.int32)
    img_gather_idx = np.zeros((B, budget), dtype=np.int32)
    num_img_tokens = np.zeros((B,), dtype=np.int32)
    tabs: List[dict] = []

    white = {
        "hidx": np.zeros((WOUT_MAX,), np.int32),
        "hw": np.zeros((WOUT_MAX, k), np.int32),
        "vidx": np.zeros((nc, 336), np.int32),
        "vw": np.zeros((nc, 336, k), np.int32),
        "vbias": np.full((nc, 336), _HALF + (255 << PRECISION_BITS), np.int32),
        "col_start": np.zeros((nc,), np.int32),
        "slot_perm": np.arange(nc, dtype=np.int32),
        "tflag": np.asarray(False),
    }
    for b, s in enumerate(samples):
        ids = s.input_ids[:seq_len]
        n = ids.shape[0]
        input_ids[b, seq_len - n :] = ids
        attention_mask[b, seq_len - n :] = s.attention_mask[:seq_len]
        splice_idx[b, seq_len - n :] = s.splice_idx[:seq_len]
        if s.src_u8 is None:
            tabs.append(white)  # text-only row: all-white bank, never gathered
            continue
        hs, ws = s.src_u8.shape[:2]
        src[b, :hs, :ws] = s.src_u8
        new_w, new_h, transposed = s.resize_geom
        t, (hc, wc) = build_hd_resize_tables(
            hs, ws, new_w, new_h, transposed, nc, kh=k, kv=k
        )
        tabs.append(t)
        crop_grid[b] = (hc, wc)
        img_gather_idx[b] = build_img_gather_idx(hc, wc, nc, budget)
        num_img_tokens[b] = s.num_img_tokens

    resize_tabs = {key: np.stack([t[key] for t in tabs]) for key in tabs[0]}
    return Batch(
        input_ids=input_ids,
        attention_mask=attention_mask,
        splice_idx=splice_idx,
        pixel_values=src,
        img_gather_idx=img_gather_idx,
        num_img_tokens=num_img_tokens,
        crop_grid=crop_grid,
        resize_tabs=resize_tabs,
    )


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

    return Batch(
        input_ids=input_ids, attention_mask=attention_mask, splice_idx=splice_idx,
        position_ids=position_ids, pixel_values=patches, patch_valid=patch_valid,
        rot_pos=rot_pos, unit_gather=unit_gather, num_img_tokens=num_img_tokens,
        img_gather_idx=None,
    )


def _put(x: Any, dev: torch.device):
    if x is None:
        return None
    if isinstance(x, Mapping):  # the device-resize tap tables
        return {k: _put(v, dev) for k, v in x.items()}
    t = torch.from_numpy(np.ascontiguousarray(x)) if isinstance(x, np.ndarray) else x
    return t.to(dev, non_blocking=True)


def to_reward_batch(batch: Mapping, device=DEFAULT_DEVICE) -> RewardBatch:
    """Numpy (or tensor) batch fields -> ``RewardBatch`` on ``device``
    (``collate.py:432-449``)."""
    dev = resolve_device(device)
    return RewardBatch(*[_put(batch.get(name), dev) for name in RewardBatch._fields])
