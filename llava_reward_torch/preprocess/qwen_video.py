"""Qwen2.5-VL video preprocessing (the port's own copy of
``llava_reward_tpu/preprocess/qwen_video.py``).

- ``smart_nframes``: the frame count (a FRAME_FACTOR multiple) from the
  element's ``fps`` / ``nframes`` and the video's length and rate;
- ``fetch_video``: frames from a path (``decord`` or ``torchvision.io``,
  imported only for a path), a list of frames, or a ``(T, H, W, 3)`` uint8
  array with ``video_fps``; linspace sampling and a bicubic resize to the
  per-video pixel budget (``VIDEO_TOTAL_PIXELS`` spread over the frames);
- ``frames_to_patches``: HF's temporal-patch flatten order;
- ``windowize_video``: the image window layout repeated per temporal slice,
  with segment ids t+1 per slice (0 for pad slots), which the full-attention
  vision blocks use to attend within one slice;
- ``mrope_position_ids_video``: M-RoPE with the temporal axis stepped by
  ``int(second_per_grid_t) * tokens_per_second``.

The host samples an even number of frames and emits static shapes; the
collator's budgets absorb what varies.
"""

from __future__ import annotations

import os
from typing import Tuple

import numpy as np

from .phi3v_processor import OPENAI_CLIP_MEAN, OPENAI_CLIP_STD
from .qwen_vision import (
    IMAGE_FACTOR,
    ceil_by_factor,
    fetch_image,
    floor_by_factor,
    round_by_factor,
    smart_resize,
    windowize,
)

VIDEO_MIN_PIXELS = 128 * 28 * 28
VIDEO_MAX_PIXELS = 768 * 28 * 28
FRAME_FACTOR = 2
FPS = 2.0
FPS_MIN_FRAMES = 4
FPS_MAX_FRAMES = 768
VIDEO_TOTAL_PIXELS = int(float(os.environ.get("VIDEO_MAX_PIXELS", 128000 * 28 * 28 * 0.9)))


def smart_nframes(ele: dict, total_frames: int, video_fps: float) -> int:
    """Frame count for the model's input (vision_process.py:143-181)."""
    assert not ("fps" in ele and "nframes" in ele), "Only accept either `fps` or `nframes`"
    if "nframes" in ele:
        nframes = round_by_factor(ele["nframes"], FRAME_FACTOR)
    else:
        fps = ele.get("fps", FPS)
        min_frames = ceil_by_factor(ele.get("min_frames", FPS_MIN_FRAMES), FRAME_FACTOR)
        max_frames = floor_by_factor(
            ele.get("max_frames", min(FPS_MAX_FRAMES, total_frames)), FRAME_FACTOR
        )
        nframes = total_frames / video_fps * fps
        nframes = min(min(max(nframes, min_frames), max_frames), total_frames)
        nframes = floor_by_factor(nframes, FRAME_FACTOR)
    if not (FRAME_FACTOR <= nframes <= total_frames):
        raise ValueError(
            f"nframes should be in [{FRAME_FACTOR}, {total_frames}], got {nframes}"
        )
    return int(nframes)


def _video_max_pixels(ele: dict, nframes: int) -> Tuple[int, int]:
    min_pixels = ele.get("min_pixels", VIDEO_MIN_PIXELS)
    total_pixels = ele.get("total_pixels", VIDEO_TOTAL_PIXELS)
    max_pixels = max(
        min(VIDEO_MAX_PIXELS, total_pixels / nframes * FRAME_FACTOR),
        int(min_pixels * 1.05),
    )
    max_pixels = min(ele.get("max_pixels", max_pixels), max_pixels)
    return int(min_pixels), int(max_pixels)


def _decode_video_path(ele: dict):
    """A video file through ``decord`` or ``torchvision.io``, the reference's
    backends (vision_process.py:183-256). Returns ((T, H, W, 3) uint8, fps)."""
    path = ele["video"]
    try:
        import decord

        vr = decord.VideoReader(path)
        total, fps = len(vr), vr.get_avg_fps()
        n = smart_nframes(ele, total, fps)
        idx = np.linspace(0, total - 1, n).round().astype(np.int64).tolist()
        return vr.get_batch(idx).asnumpy(), fps * n / max(total, 1e-6)
    except ImportError:
        pass
    try:
        from torchvision import io as tvio

        video, _, info = tvio.read_video(path, pts_unit="sec", output_format="THWC")
        total, fps = video.shape[0], info["video_fps"]
        n = smart_nframes(ele, total, fps)
        idx = np.linspace(0, total - 1, n).round().astype(np.int64)
        return video[idx].numpy(), fps * n / max(total, 1e-6)
    except ImportError as e:
        raise ImportError(
            "decoding video FILES needs decord or torchvision (neither "
            "installed); pass pre-decoded frames instead — a list of PIL "
            "images or a (T, H, W, 3) uint8 array via {'video': frames, "
            "'video_fps': fps}"
        ) from e


def fetch_video(
    ele: dict, image_factor: int = IMAGE_FACTOR
) -> Tuple[np.ndarray, float]:
    """-> ((T, H', W', 3) float32 RGB in [0, 255], sample_fps); T is a
    FRAME_FACTOR multiple, H' and W' multiples of the factor within the
    per-video budget (vision_process.py:278-331)."""
    from PIL import Image

    video = ele["video"]
    if isinstance(video, str):
        frames, sample_fps = _decode_video_path(ele)
    elif isinstance(video, (list, tuple)):
        # a frame list: each frame through fetch_image with the caller's
        # pixel budget, the list padded to a FRAME_FACTOR multiple, and no
        # re-resize to the video budget (vision_process.py:318-331)
        kw = {}
        if "min_pixels" in ele:
            kw["min_pixels"] = ele["min_pixels"]
        if "max_pixels" in ele:
            kw["max_pixels"] = ele["max_pixels"]
        imgs = [
            fetch_image(
                f if isinstance(f, Image.Image) else Image.fromarray(np.asarray(f)),
                image_factor, **kw,
            )
            for f in video
        ]
        n = ceil_by_factor(len(imgs), FRAME_FACTOR)
        imgs = list(imgs) + [imgs[-1]] * (n - len(imgs))
        frames = np.stack([np.asarray(i.convert("RGB"), np.float32) for i in imgs])
        return frames, float(ele.get("fps", FPS))
    else:
        frames = np.asarray(video)
        assert frames.ndim == 4 and frames.shape[-1] == 3, frames.shape
        total = frames.shape[0]
        fps = ele.get("video_fps", FPS)
        n = smart_nframes(ele, total, fps)
        idx = np.linspace(0, total - 1, n).round().astype(np.int64)
        frames = frames[idx]
        sample_fps = fps * n / max(total, 1e-6)

    T, H, W = frames.shape[:3]
    min_px, max_px = _video_max_pixels(ele, T)
    if "resized_height" in ele and "resized_width" in ele:
        h_bar, w_bar = smart_resize(
            ele["resized_height"], ele["resized_width"], image_factor
        )
    else:
        h_bar, w_bar = smart_resize(H, W, image_factor, min_px, max_px)
    out = np.empty((T, h_bar, w_bar, 3), np.float32)
    for t in range(T):
        im = Image.fromarray(frames[t].astype(np.uint8))
        out[t] = np.asarray(im.resize((w_bar, h_bar), Image.BICUBIC), np.float32)
    return out, float(sample_fps)


def frames_to_patches(
    frames: np.ndarray,  # (T, H, W, 3) float32 [0, 255]
    patch_size: int = 14,
    temporal_patch_size: int = 2,
    merge_size: int = 2,
) -> Tuple[np.ndarray, Tuple[int, int, int]]:
    """(grid_t*gh*gw, C*tps*ps*ps) patches in HF's flatten order
    (Qwen2VLImageProcessor._preprocess: t-major, merged-block-major within
    each temporal unit, per-patch flat (C, tps, ph, pw)) and the grid
    (grid_t, gh, gw)."""
    T, H, W, C = frames.shape
    assert T % temporal_patch_size == 0, (T, temporal_patch_size)
    x = frames / 255.0
    x = (x - OPENAI_CLIP_MEAN) / OPENAI_CLIP_STD
    x = x.transpose(0, 3, 1, 2)  # (T, C, H, W)

    gt = T // temporal_patch_size
    gh, gw = H // patch_size, W // patch_size
    m = merge_size
    x = x.reshape(
        gt, temporal_patch_size, C, gh // m, m, patch_size, gw // m, m, patch_size
    )
    x = x.transpose(0, 3, 6, 4, 7, 2, 1, 5, 8)
    patches = x.reshape(gt * gh * gw, C * temporal_patch_size * patch_size * patch_size)
    return patches.astype(np.float32), (gt, gh, gw)


def windowize_video(
    grid: Tuple[int, int, int],
    window_size: int = 112,
    patch_size: int = 14,
    merge_size: int = 2,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, int]:
    """The window layout per temporal slice (HF's get_window_index walks the
    grid_t slices one by one): one slice's ``windowize`` repeated with patch
    and unit offsets.

    ``patch_seg`` holds segment ids, t+1 for slice t and 0 for pad slots: the
    full-attention vision blocks attend within one temporal slice (HF's
    cu_seqlens are per slice), which the attention enforces with
    ``mask_layout="segments"``."""
    gt, gh, gw = grid
    src1, valid1, gather1, n_win1 = windowize(
        (1, gh, gw), window_size, patch_size, merge_size
    )
    m = merge_size
    slots_per_t = src1.shape[0]
    patch_src = np.concatenate([src1 + t * gh * gw for t in range(gt)])
    patch_seg = np.concatenate(
        [valid1.astype(np.int32) * (t + 1) for t in range(gt)]
    )
    unit_gather = np.concatenate(
        [gather1 + t * slots_per_t // (m * m) for t in range(gt)]
    )
    return patch_src.astype(np.int32), patch_seg, unit_gather.astype(np.int32), n_win1 * gt


def mrope_position_ids_video(
    input_ids: np.ndarray,
    video_token_id: int,
    grid: Tuple[int, int, int],
    merge_size: int = 2,
    second_per_grid_t: float = 1.0,
    tokens_per_second: float = 4.0,
) -> np.ndarray:
    """(3, S) M-RoPE with the Qwen2.5 video temporal axis: unit (t, h, w)
    takes t = t0 + t_idx * int(second_per_grid_t) * tokens_per_second.

    The ``int()`` comes first, as in HF's get_rope_index, which makes
    second_per_grid_t an int64 tensor before the multiply: a fractional
    value floors (0.5 gives all-zero temporal steps). tokens_per_second 4 is
    Qwen2_5_VLVisionConfig's."""
    S = input_ids.shape[0]
    pos = np.zeros((3, S), np.int64)
    vid_mask = input_ids == video_token_id
    if not vid_mask.any():
        p = np.arange(S)
        return np.stack([p, p, p]).astype(np.int32)

    gt, gh, gw = grid
    m = merge_size
    lh, lw = gh // m, gw // m
    t_step = int(second_per_grid_t) * tokens_per_second  # HF's order: floor, then multiply
    cur = 0
    i = 0
    while i < S:
        if not vid_mask[i]:
            pos[:, i] = cur
            cur += 1
            i += 1
        else:
            n = gt * lh * lw
            t0 = cur
            t_idx = (np.arange(gt) * t_step).astype(np.int64)
            pos[0, i : i + n] = t0 + np.repeat(t_idx, lh * lw)
            pos[1, i : i + n] = t0 + np.tile(np.arange(lh).repeat(lw), gt)
            pos[2, i : i + n] = t0 + np.tile(np.tile(np.arange(lw), lh), gt)
            cur = int(pos[:, i : i + n].max()) + 1
            i += n
    return pos.astype(np.int32)
