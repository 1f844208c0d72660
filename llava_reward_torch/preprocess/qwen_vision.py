"""Qwen2.5-VL host-side image processing (the port's own copy of
``llava_reward_tpu/preprocess/qwen_vision.py``, images).

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
takes. ``Qwen25VLProcessor`` makes one from a prompt and PIL images
(``fetch_image``: smart_resize and a bicubic resize; ``image_to_patches``:
HF's flatten order, f32 normalised or raw uint8 with ``device_preproc``);
``sample_from_patches`` makes one from a token stream and one image's
patches. A video (``videos=[...]``: frames or a path,
``preprocess/qwen_video.py``) goes through ``_call_video``.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np

from ..ops.pixels import OPENAI_CLIP_MEAN, OPENAI_CLIP_STD

IMAGE_FACTOR = 28
MIN_PIXELS = 4 * 28 * 28
MAX_PIXELS = 16384 * 28 * 28
MAX_RATIO = 200



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


def fetch_image(
    image,
    factor: int = IMAGE_FACTOR,
    min_pixels: int = MIN_PIXELS,
    max_pixels: int = MAX_PIXELS,
):
    """PIL path of vision_process.py:97-140 (file/URL/base64 IO lives in the
    data layer)."""
    from PIL import Image

    img = image.convert("RGB")
    w, h = img.size
    h_bar, w_bar = smart_resize(h, w, factor, min_pixels, max_pixels)
    return img.resize((w_bar, h_bar), Image.BICUBIC)


def patch_norm_vectors(C: int = 3, tps: int = 2, ps: int = 14):
    """(patch_dim,) CLIP mean and std in the patch-flat (C, tps, ph, pw) order."""
    rep = tps * ps * ps
    mean = np.repeat(OPENAI_CLIP_MEAN[:C], rep)
    std = np.repeat(OPENAI_CLIP_STD[:C], rep)
    return mean, std


def image_to_patches(
    image,
    patch_size: int = 14,
    temporal_patch_size: int = 2,
    merge_size: int = 2,
    min_pixels: int = MIN_PIXELS,
    max_pixels: int = MAX_PIXELS,
    layout: str = "f32",
) -> Tuple[np.ndarray, Tuple[int, int, int]]:
    """PIL image -> (num_patches, C*tps*ps*ps) + grid (t, h, w), in
    merged-block-major patch order with per-patch flat layout (C, tps, ph, pw)
    — exactly Qwen2VLImageProcessor._preprocess's flatten order.

    ``layout='f32'``: CLIP-normalised float32 (host does everything);
    ``layout='u8'``: RAW uint8 patches — normalisation runs on device
    (patch_norm_vectors), cutting host work and wire bytes 4x."""
    img = fetch_image(image, patch_size * merge_size, min_pixels, max_pixels)
    w_bar, h_bar = img.size
    if layout == "u8":
        x = np.asarray(img, dtype=np.uint8)
    else:
        x = np.asarray(img, dtype=np.float32) / 255.0
        x = (x - OPENAI_CLIP_MEAN) / OPENAI_CLIP_STD  # (H, W, C)
    x = x.transpose(2, 0, 1)  # (C, H, W)
    x = np.tile(x[None], (temporal_patch_size, 1, 1, 1))  # (tps, C, H, W)

    C = x.shape[1]
    gh, gw = h_bar // patch_size, w_bar // patch_size
    m = merge_size
    x = x.reshape(
        temporal_patch_size, C, gh // m, m, patch_size, gw // m, m, patch_size
    )
    # -> (gh/m, gw/m, m, m, C, tps, ps, ps): merged-block-major patch order
    x = x.transpose(2, 5, 3, 6, 1, 0, 4, 7)
    patches = x.reshape(gh * gw, C * temporal_patch_size * patch_size * patch_size)
    return patches, (1, gh, gw)


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


class Qwen25VLProcessor:
    """Tokenizer + image processor; the prompt must contain ONE literal
    ``<|image_pad|>`` token (the chat template's vision span)."""

    def __init__(
        self,
        tokenizer,
        patch_size: int = 14,
        temporal_patch_size: int = 2,
        merge_size: int = 2,
        window_size: int = 112,
        min_pixels: int = 256 * 28 * 28,  # (utils/utils.py:35-37)
        max_pixels: int = 1280 * 28 * 28,
        image_token_id: int = 151655,
        device_preproc: bool = False,
    ):
        # ship RAW uint8 patches and normalise on device (4x fewer wire
        # bytes; models/qwen25_vl.vision_forward). Images only — video
        # frames stay f32 (they are resampled floats, and u8 rounding
        # would deviate from the reference)
        self.device_preproc = device_preproc
        self.tokenizer = tokenizer
        self.patch_size = patch_size
        self.temporal_patch_size = temporal_patch_size
        self.merge_size = merge_size
        self.window_size = window_size
        self.min_pixels = min_pixels
        self.max_pixels = max_pixels
        self.image_token_id = image_token_id

    @property
    def max_patches(self) -> int:
        return self.max_pixels // (self.patch_size * self.patch_size)

    def _tokenize(self, text: str) -> List[int]:
        out = self.tokenizer(text)
        if hasattr(out, "input_ids"):
            return list(out.input_ids)
        if isinstance(out, dict):
            return list(out["input_ids"])
        return list(out)

    def __call__(
        self, text: str, images: Sequence = (), videos: Sequence = ()
    ) -> QwenProcessedSample:
        ids = np.asarray(self._tokenize(text), dtype=np.int32)
        if videos:
            return self._call_video(ids, videos)
        if not images:
            p = np.arange(len(ids), dtype=np.int32)
            return QwenProcessedSample(
                ids, np.ones_like(ids), np.stack([p, p, p]),
                np.full_like(ids, -1), None, None, None, None, None, 0,
            )
        # Multi-image: one <|image_pad|> per image in prompt order (the
        # reference's process_vision_info walks arbitrary per-message image
        # lists, qwen_vl_utils/vision_process.py:352-377). Each image keeps
        # its own windowed layout; they concatenate along the patch axis
        # (window boundaries stay aligned — every image's layout is a whole
        # number of windows) and full-attention blocks separate images via
        # per-image segment ids, exactly as HF's cu_seqlens do.
        m = self.merge_size
        mm = m * m
        pad_positions = np.nonzero(ids == self.image_token_id)[0]
        if len(pad_positions) != len(images):
            raise ValueError(f"prompt has {len(pad_positions)} <|image_pad|> for "
                             f"{len(images)} images")

        per_patches, per_grids = [], []
        for img in images:
            patches, grid = image_to_patches(
                img, self.patch_size, self.temporal_patch_size,
                self.merge_size, self.min_pixels, self.max_pixels,
                layout="u8" if self.device_preproc else "f32",
            )
            per_patches.append(patches)
            per_grids.append(grid)

        # expand each pad token to its image's merged-unit run; global unit
        # slots are consecutive across images (image i's units follow i-1's)
        segs, splice_segs = [], []
        cursor = 0
        unit_base = 0
        for p, grid in zip(pad_positions, per_grids):
            n_merged = (grid[1] // m) * (grid[2] // m)
            segs.append(ids[cursor:p])
            splice_segs.append(np.full(p - cursor, -1, np.int32))
            segs.append(np.full(n_merged, self.image_token_id, np.int32))
            splice_segs.append(unit_base + np.arange(n_merged, dtype=np.int32))
            unit_base += n_merged
            cursor = p + 1
        segs.append(ids[cursor:])
        splice_segs.append(np.full(len(ids) - cursor, -1, np.int32))
        ids = np.concatenate(segs).astype(np.int32)
        splice = np.concatenate(splice_segs)

        # windowed layouts concatenate; unit_gather offsets by the previous
        # images' WINDOWED unit counts, segment ids are i+1 per image
        w_patches, w_valid, w_rot, gathers = [], [], [], []
        w_unit_base = 0
        for i, (patches, grid) in enumerate(zip(per_patches, per_grids)):
            patch_src, valid, unit_gather, _ = windowize(
                grid, self.window_size, self.patch_size, self.merge_size
            )
            rot = _merged_block_pos(grid[1], grid[2], m)
            w_patches.append(patches[patch_src] * valid[:, None])
            w_valid.append((valid.astype(np.int32)) * (i + 1))
            w_rot.append(rot[patch_src] * valid[:, None].astype(np.int32))
            gathers.append(unit_gather + w_unit_base)
            w_unit_base += len(patch_src) // mm
        return QwenProcessedSample(
            input_ids=ids,
            attention_mask=np.ones_like(ids),
            position_ids=mrope_position_ids(ids, self.image_token_id, per_grids, m),
            splice_idx=splice,
            patches=np.concatenate(w_patches, axis=0),
            patch_valid=np.concatenate(w_valid),
            rot_pos=np.concatenate(w_rot, axis=0),
            unit_gather=np.concatenate(gathers),
            grid_thw=per_grids[0] if len(per_grids) == 1 else tuple(per_grids),
            num_img_tokens=unit_base,
        )

    # ------------------------------------------------------------- video
    VIDEO_TOKEN_ID = 151656  # <|video_pad|>

    def _call_video(self, ids: np.ndarray, videos: Sequence) -> QwenProcessedSample:
        """One video a sample: the <|video_pad|> token expands to
        grid_t * lh * lw merged units, with temporal M-RoPE and windows per
        temporal slice (``qwen_video.py``; vision_process.py:143-331). The
        patches stay f32 whatever ``device_preproc`` says: the frames are
        resampled floats."""
        from .qwen_video import (
            fetch_video,
            frames_to_patches,
            mrope_position_ids_video,
            windowize_video,
        )

        if len(videos) != 1:
            raise NotImplementedError("one video per sample (v1)")
        ele = videos[0] if isinstance(videos[0], dict) else {"video": videos[0]}
        frames, sample_fps = fetch_video(ele)
        patches, grid = frames_to_patches(
            frames, self.patch_size, self.temporal_patch_size, self.merge_size
        )
        m = self.merge_size
        gt, gh, gw = grid
        n_merged = gt * (gh // m) * (gw // m)

        pad_positions = np.nonzero(ids == self.VIDEO_TOKEN_ID)[0]
        if len(pad_positions) != 1:
            raise ValueError(f"prompt has {len(pad_positions)} <|video_pad|>, not one")
        p = int(pad_positions[0])
        ids = np.concatenate(
            [ids[:p], np.full(n_merged, self.VIDEO_TOKEN_ID, np.int32), ids[p + 1 :]]
        )
        splice = np.full(len(ids), -1, np.int32)
        splice[p : p + n_merged] = np.arange(n_merged)

        patch_src, patch_seg, unit_gather, _ = windowize_video(
            grid, self.window_size, self.patch_size, self.merge_size
        )
        patch_ok = patch_seg > 0
        rot = np.tile(_merged_block_pos(gh, gw, m), (gt, 1))  # spatial rotary, per slice
        pos = mrope_position_ids_video(
            ids, self.VIDEO_TOKEN_ID, grid, m,
            second_per_grid_t=self.temporal_patch_size / max(sample_fps, 1e-6),
            tokens_per_second=4.0,  # Qwen2_5_VLVisionConfig.tokens_per_second
        )
        return QwenProcessedSample(
            input_ids=ids,
            attention_mask=np.ones_like(ids),
            position_ids=pos,
            splice_idx=splice,
            patches=patches[patch_src] * patch_ok[:, None],
            patch_valid=patch_seg,  # segment ids: t+1 per slice, 0 = pad
            rot_pos=rot[patch_src] * patch_ok[:, None].astype(np.int32),
            unit_gather=unit_gather,
            grid_thw=grid,
            num_img_tokens=n_merged,
        )


def apply_qwen_chat_template(tokenizer, prompt: str) -> str:
    """Dataset-layer prompt construction (reward_dataset.py:404-430: the
    rendered template is sliced [58:-23] and stripped — the result is the
    vision span + prompt text)."""
    text = tokenizer.apply_chat_template(
        [
            {
                "role": "user",
                "content": [
                    {"type": "image"},
                    {"type": "text", "text": prompt},
                ],
            }
        ],
        tokenize=False,
        add_generation_prompt=True,
    )
    return text[58:-23].strip()
