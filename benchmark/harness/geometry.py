"""Image geometry of both families, from the published processors' rules:
Phi-3.5-vision's HD transform (processing_phi3_v.py: the crop grid and the
image-token count) and Qwen2.5-VL's smart resize, patches, merged units and
windows (qwen_vl_utils / Qwen2.5-VL's vision tower). The plain references
and the FLOP counters read these; nothing here comes from the port.
"""

from __future__ import annotations

import math
from typing import Tuple


def phi3v_hd(width: int, height: int, num_crops: int = 16, crop: int = 336
             ) -> Tuple[int, int, int, bool]:
    """HD_transform in landscape orientation: the resized width and height,
    the height padded white to a crop multiple, and whether the image was
    transposed (portrait)."""
    transposed = width < height
    if transposed:
        width, height = height, width
    ratio = width / height
    scale = 1
    while scale * math.ceil(scale / ratio) <= num_crops:
        scale += 1
    scale -= 1
    new_w = int(scale * crop)
    new_h = int(new_w / ratio)
    target_h = int(math.ceil(new_h / crop) * crop)
    return new_w, new_h, target_h, transposed


def phi3v_grid(width: int, height: int, num_crops: int = 16, crop: int = 336) -> Tuple[int, int]:
    """(hc, wc): crop rows and columns of the HD image."""
    new_w, _, target_h, transposed = phi3v_hd(width, height, num_crops, crop)
    hc, wc = target_h // crop, new_w // crop
    return (wc, hc) if transposed else (hc, wc)


def phi3v_tokens(hc: int, wc: int) -> int:
    """Image tokens: 144 a crop and the global view, a newline a row."""
    return (hc * wc + 1) * 144 + 1 + (hc + 1) * 12


def qwen_resize(height: int, width: int, factor: int, min_pixels: int, max_pixels: int
                ) -> Tuple[int, int]:
    """smart_resize: the nearest factor multiple within the pixel limits."""
    h = max(factor, round(height / factor) * factor)
    w = max(factor, round(width / factor) * factor)
    if h * w > max_pixels:
        beta = math.sqrt(height * width / max_pixels)
        h = math.floor(height / beta / factor) * factor
        w = math.floor(width / beta / factor) * factor
    elif h * w < min_pixels:
        beta = math.sqrt(min_pixels / (height * width))
        h = math.ceil(height * beta / factor) * factor
        w = math.ceil(width * beta / factor) * factor
    return h, w


def qwen_grid(width: int, height: int, v: dict, min_pixels: int, max_pixels: int
              ) -> Tuple[int, int]:
    """(gh, gw) patches of an image."""
    ps, m = v["patch_size"], v["spatial_merge_size"]
    h, w = qwen_resize(height, width, ps * m, min_pixels, max_pixels)
    return h // ps, w // ps


def qwen_windows(gh: int, gw: int, v: dict):
    """Valid patches of each window, row-major over windows of
    ``window_size / patch_size / merge`` units a side."""
    m = v["spatial_merge_size"]
    win = v["window_size"] // v["patch_size"] // m
    lh, lw = gh // m, gw // m
    out = []
    for i in range(0, lh, win):
        for j in range(0, lw, win):
            out.append(min(win, lh - i) * min(win, lw - j) * m * m)
    return out
