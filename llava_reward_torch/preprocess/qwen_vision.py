"""Qwen2.5-VL image geometry in numpy (the port's own copy of
``llava_reward_tpu/preprocess/qwen_vision.py:38-74,92-99,140-240``).

- ``smart_resize``: factor-28 sizes within [min_pixels, max_pixels];
- ``patch_norm_vectors``: the CLIP mean / std in the patch-flat
  (C, tps, ph, pw) order, the device-side normaliser of uint8 patch banks
  (``models/qwen25_vl.vision_forward``);
- ``windowize``: the static window layout. The host emits the patches in
  window order, padded so every window is a full ``win_patches`` block:
  window attention on the device is a reshape to (num_windows,
  win_patches) and batched dense attention, and the full-attention blocks
  use a segment-id row (0 = pad). ``unit_gather`` restores the merger's
  output to the original merged-unit order;
- ``mrope_position_ids``: M-RoPE (t, h, w) positions of a token stream.

``QwenProcessedSample`` is what ``preprocess/collate.collate_qwen_samples``
takes; ``sample_from_patches`` builds one from a token stream and one
image's patches, as ``Qwen25VLProcessor.__call__`` does after decoding and
resizing (``qwen_vision.py:300-380``, one image). The PIL half of the
processor (``fetch_image``, ``image_to_patches``) and video arrive with the
host data path (ROADMAP A8a).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np

IMAGE_FACTOR = 28
MIN_PIXELS = 4 * 28 * 28
MAX_PIXELS = 16384 * 28 * 28
MAX_RATIO = 200

OPENAI_CLIP_MEAN = np.array([0.48145466, 0.4578275, 0.40821073], dtype=np.float32)
OPENAI_CLIP_STD = np.array([0.26862954, 0.26130258, 0.27577711], dtype=np.float32)


def round_by_factor(number: float, factor: int) -> int:
    return round(number / factor) * factor


def ceil_by_factor(number: float, factor: int) -> int:
    return math.ceil(number / factor) * factor


def floor_by_factor(number: float, factor: int) -> int:
    return math.floor(number / factor) * factor


def smart_resize(
    height: int,
    width: int,
    factor: int = IMAGE_FACTOR,
    min_pixels: int = MIN_PIXELS,
    max_pixels: int = MAX_PIXELS,
) -> Tuple[int, int]:
    if max(height, width) / min(height, width) > MAX_RATIO:
        raise ValueError(
            f"aspect ratio must be < {MAX_RATIO}, got "
            f"{max(height, width) / min(height, width)}"
        )
    h_bar = max(factor, round_by_factor(height, factor))
    w_bar = max(factor, round_by_factor(width, factor))
    if h_bar * w_bar > max_pixels:
        beta = math.sqrt((height * width) / max_pixels)
        h_bar = floor_by_factor(height / beta, factor)
        w_bar = floor_by_factor(width / beta, factor)
    elif h_bar * w_bar < min_pixels:
        beta = math.sqrt(min_pixels / (height * width))
        h_bar = ceil_by_factor(height * beta, factor)
        w_bar = ceil_by_factor(width * beta, factor)
    return h_bar, w_bar


def patch_norm_vectors(C: int = 3, tps: int = 2, ps: int = 14):
    """(patch_dim,) CLIP mean and std in the patch-flat (C, tps, ph, pw) order."""
    rep = tps * ps * ps
    mean = np.repeat(OPENAI_CLIP_MEAN[:C], rep)
    std = np.repeat(OPENAI_CLIP_STD[:C], rep)
    return mean, std


def _merged_block_pos(gh: int, gw: int, m: int) -> np.ndarray:
    """(num_patches, 2) (h, w) positions in merged-block patch order."""
    hpos = np.arange(gh)[:, None].repeat(gw, 1)
    wpos = np.arange(gw)[None, :].repeat(gh, 0)

    def reorder(p):
        return p.reshape(gh // m, m, gw // m, m).transpose(0, 2, 1, 3).reshape(-1)

    return np.stack([reorder(hpos), reorder(wpos)], axis=-1).astype(np.int32)


def windowize(
    grid: Tuple[int, int, int],
    window_size: int = 112,
    patch_size: int = 14,
    merge_size: int = 2,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, int]:
    """Static window layout of one image: (patch_src, patch_valid,
    unit_gather, n_windows).

    - ``patch_src`` (n_windows*win_patches,): the source index, in
      merged-block patch order, of each windowed patch slot (0 for pads);
    - ``patch_valid``: same shape, bool;
    - ``unit_gather`` (n_units,): each original merged unit's index in the
      windowed layout;
    - ``n_windows``. Partial windows are padded.
    """
    _, gh, gw = grid
    m = merge_size
    mm = m * m
    lh, lw = gh // m, gw // m
    win = window_size // patch_size // m  # units per window side
    nwh, nww = math.ceil(lh / win), math.ceil(lw / win)
    n_windows = nwh * nww

    unit_idx = np.full((nwh * win, nww * win), -1, np.int64)
    unit_idx[:lh, :lw] = np.arange(lh * lw).reshape(lh, lw)
    # (nwh, win, nww, win) -> (nwh, nww, win, win) -> window-major units
    u = unit_idx.reshape(nwh, win, nww, win).transpose(0, 2, 1, 3).reshape(-1)

    unit_gather = np.zeros(lh * lw, np.int32)
    unit_gather[u[u >= 0]] = np.nonzero(u >= 0)[0].astype(np.int32)

    patch_src = np.where(u >= 0, u, 0)[:, None] * mm + np.arange(mm)[None, :]
    patch_valid = np.repeat(u >= 0, mm)
    return patch_src.reshape(-1).astype(np.int32), patch_valid, unit_gather, n_windows


def mrope_position_ids(
    input_ids: np.ndarray,
    image_token_id: int,
    grids,  # one (t, h, w) tuple, a list of them (one per image), or None
    merge_size: int = 2,
) -> np.ndarray:
    """(3, S) int32: text advances all axes; each image-token run holds t and
    sweeps (h, w) over that image's merged grid; images take their grids in
    prompt order."""
    S = input_ids.shape[0]
    pos = np.zeros((3, S), np.int64)
    img_mask = input_ids == image_token_id
    if grids is None or not img_mask.any():
        p = np.arange(S)
        return np.stack([p, p, p]).astype(np.int32)
    if isinstance(grids, tuple) and len(grids) == 3 and np.isscalar(grids[0]):
        grids = [grids]

    img_no = 0
    cur = 0
    i = 0
    while i < S:
        if not img_mask[i]:
            pos[:, i] = cur
            cur += 1
            i += 1
        else:
            _, gh, gw = grids[img_no]
            lh, lw = gh // merge_size, gw // merge_size
            img_no += 1
            n = lh * lw
            t0 = cur
            pos[0, i : i + n] = t0
            pos[1, i : i + n] = t0 + np.arange(lh).repeat(lw)
            pos[2, i : i + n] = t0 + np.tile(np.arange(lw), lh)
            cur = t0 + max(lh, lw)
            i += n
    return pos.astype(np.int32)


@dataclass
class QwenProcessedSample:
    input_ids: np.ndarray  # (s,)
    attention_mask: np.ndarray  # (s,)
    position_ids: np.ndarray  # (3, s) M-RoPE
    splice_idx: np.ndarray  # (s,) merged-token slot or -1
    patches: Optional[np.ndarray]  # (n_windows*win_patches, patch_dim), windowed
    patch_valid: Optional[np.ndarray]  # same leading shape: segment ids, 0 = pad
    rot_pos: Optional[np.ndarray]  # (n_windows*win_patches, 2), windowed order
    unit_gather: Optional[np.ndarray]  # (n_units,) original unit -> windowed unit
    grid_thw: Optional[Tuple[int, int, int]]
    num_img_tokens: int  # merged units == LLM image tokens


def sample_from_patches(
    ids: np.ndarray,  # (s,) token ids holding ONE image_token_id placeholder
    patches: np.ndarray,  # (gh*gw, patch_dim) in merged-block order, f32 or u8
    grid: Tuple[int, int, int],
    image_token_id: int,
    window_size: int = 112,
    patch_size: int = 14,
    merge_size: int = 2,
) -> QwenProcessedSample:
    """The placeholder expands to the image's merged-unit run; the patches,
    their (h, w) positions and segment id 1 go to the windowed layout, pad
    slots zero."""
    ids = np.asarray(ids, np.int32)
    (p,) = np.nonzero(ids == image_token_id)[0]
    n_units = (grid[1] // merge_size) * (grid[2] // merge_size)
    ids = np.concatenate([ids[:p], np.full(n_units, image_token_id, np.int32), ids[p + 1 :]])
    splice = np.full(len(ids), -1, np.int32)
    splice[p : p + n_units] = np.arange(n_units, dtype=np.int32)
    patch_src, valid, unit_gather, _ = windowize(grid, window_size, patch_size, merge_size)
    rot = _merged_block_pos(grid[1], grid[2], merge_size)
    return QwenProcessedSample(
        input_ids=ids,
        attention_mask=np.ones_like(ids),
        position_ids=mrope_position_ids(ids, image_token_id, [grid], merge_size),
        splice_idx=splice,
        patches=patches[patch_src] * valid[:, None],
        patch_valid=valid.astype(np.int32),
        rot_pos=rot[patch_src] * valid[:, None].astype(np.int32),
        unit_gather=unit_gather,
        grid_thw=grid,
        num_img_tokens=n_units,
    )
