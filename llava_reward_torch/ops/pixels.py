"""Device-side image preparation for Phi-3.5-V (the port's own copy of
``llava_reward_tpu/ops/pixels.py``), as torch ops on the batch's device.

The host ships a uint8 crop bank (a quarter of the f32 bank's bytes, and
no host normalise or resize) plus the (hc, wc) crop grid; on the device:

  1. u8 -> f32, /255, per-channel CLIP normalisation;
  2. the 336x336 global view as block-separable bicubic products:
     G = sum_c KyBand[hc, r_c] @ crop_c @ KxBand[wc, col_c]^T, where KyBand is
     a constant (max_grid, max_grid, 336, 336) bank of torch-parity
     cubic-convolution weight slices (rows sum to 1, so the resize commutes
     with the affine normalisation the host applies first, to float rounding).

The two products of ``prepare_pixel_bank`` run in float64 and the view is
rounded to fp32 once: a fp32 product would take TF32 wherever the caller's
matmul settings allow it, and float64 has no such path.

``hd_resize_u8_bank`` runs the HD bilinear resize itself on the device from
the decoded original (PIL's fixed-point arithmetic, int32, bit-equal to the
host's ``hd_transform_image``). Grids up to ``MAX_GRID`` = 8 a side cover
every num_crops = 16 geometry but the 16x1 / 1x16 panoramas, which the
processor sends down the host f32 path. Neither op holds a TPU kernel in
the JAX package (XLA einsums and an int32 gather-multiply-accumulate).
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

OPENAI_CLIP_MEAN = np.asarray([0.48145466, 0.4578275, 0.40821073], np.float32)
OPENAI_CLIP_STD = np.asarray([0.26862954, 0.26130258, 0.27577711], np.float32)

CROP = 336
MAX_GRID = 8  # covers every hc*wc <= 16 grid except 16x1/1x16 panoramas


def bicubic_weight_matrix(in_size: int, out_size: int = CROP) -> np.ndarray:
    """Dense (out_size, in_size) torch-parity bicubic weights (cubic
    convolution a=-0.75, align_corners=False, no antialias): the matrix form
    of ``preprocess.phi3v_processor._resize_bicubic_1d``."""
    scale = in_size / out_size
    coords = (np.arange(out_size) + 0.5) * scale - 0.5
    base = np.floor(coords).astype(np.int64)
    frac = coords - base
    taps = np.stack([base - 1, base, base + 1, base + 2], axis=1)
    taps = np.clip(taps, 0, in_size - 1)
    offs = np.stack([frac + 1, frac, 1 - frac, 2 - frac], axis=1)
    ax = np.abs(offs)
    a = -0.75
    ax2, ax3 = ax * ax, ax * ax * ax
    weights = np.where(
        ax <= 1,
        (a + 2) * ax3 - (a + 3) * ax2 + 1,
        np.where(ax < 2, a * ax3 - 5 * a * ax2 + 8 * a * ax - 4 * a, 0.0),
    )
    W = np.zeros((out_size, in_size), np.float32)
    for o in range(out_size):
        for t in range(4):
            W[o, taps[o, t]] += weights[o, t]
    return W


@functools.lru_cache(maxsize=2)
def _band_bank_np(max_grid: int = MAX_GRID) -> np.ndarray:
    """(max_grid, max_grid, 336, 336): entry [g, r] is columns
    [r*336, (r+1)*336) of the (336, (g+1)*336) bicubic matrix (zero for
    r > g)."""
    bank = np.zeros((max_grid, max_grid, CROP, CROP), np.float32)
    for g in range(max_grid):
        W = bicubic_weight_matrix((g + 1) * CROP)
        for r in range(g + 1):
            bank[g, r] = W[:, r * CROP : (r + 1) * CROP]
    return bank


@functools.lru_cache(maxsize=4)
def _band_bank(device: str, max_grid: int) -> torch.Tensor:
    """The band bank on ``device`` in float64 (exact: its values are fp32)."""
    return torch.from_numpy(_band_bank_np(max_grid)).to(device=device, dtype=torch.float64)


def normalize_pixels(x: torch.Tensor, dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """uint8 (or 0-255 float) -> CLIP-normalised, channels-last."""
    x = x.to(torch.float32) / 255.0
    mean = torch.from_numpy(OPENAI_CLIP_MEAN).to(x.device)
    std = torch.from_numpy(OPENAI_CLIP_STD).to(x.device)
    return ((x - mean) / std).to(dtype)


def prepare_pixel_bank(
    crops_u8: torch.Tensor,  # (B, nc, 336, 336, 3) uint8; slots 0..hc*wc-1 valid
    crop_grid: torch.Tensor,  # (B, 2) int32 (hc, wc), each <= max_grid
    *,
    dtype: torch.dtype = torch.float32,
    max_grid: int = MAX_GRID,
) -> torch.Tensor:
    """uint8 crop bank -> (B, nc+1, 336, 336, 3) normalised [global, crops...],
    equal to the host ``preprocess_image`` bank to float rounding."""
    B, nc, _, W, C = crops_u8.shape
    dev = crops_u8.device
    bank = _band_bank(str(dev), max_grid)  # (G, G, 336, 336) float64

    crop_grid = crop_grid.to(device=dev, dtype=torch.int64)
    hc = crop_grid[:, 0].clamp(1, max_grid)
    wc = crop_grid[:, 1].clamp(1, max_grid)
    slot = torch.arange(nc, device=dev)
    r = slot[None, :] // wc[:, None]  # (B, nc)
    col = slot[None, :] % wc[:, None]
    valid = slot[None, :] < (hc * wc)[:, None]
    r = torch.where(valid & (r < max_grid), r, torch.zeros_like(r))
    col = torch.where(valid, col, torch.zeros_like(col))

    # per-slot weight slices: Ky[b, c] = bank[hc-1, r_c], zero when invalid
    ky = bank[hc[:, None] - 1, r] * valid[..., None, None]  # (B, nc, 336y, 336h)
    kx = bank[wc[:, None] - 1, col]  # (B, nc, 336x, 336w)

    x = crops_u8.to(torch.float64).reshape(B * nc, CROP, W * C)
    # tmp[b, c] = Ky_c @ crop_c, then G[b] = sum_c tmp_c @ Kx_c^T
    tmp = torch.bmm(ky.reshape(B * nc, CROP, CROP), x).reshape(B, nc, CROP, W, C)
    tmp = tmp.permute(0, 2, 4, 1, 3).reshape(B, CROP * C, nc * W)  # (b, y n, c w)
    glb = torch.bmm(tmp, kx.permute(0, 1, 3, 2).reshape(B, nc * W, CROP))  # (b, y n, x)
    glb = glb.reshape(B, CROP, C, CROP).permute(0, 1, 3, 2).to(torch.float32)

    full = torch.cat([glb[:, None], crops_u8.to(torch.float32)], dim=1)  # (B, nc+1, ...)
    return normalize_pixels(full, dtype=dtype)


# ---------------------------------------------------------------- HD resize
#
# The host ships the DECODED uint8 original plus small per-sample tap tables;
# the resize, white padding and crop split run on the device, and the result
# feeds prepare_pixel_bank. PIL's BILINEAR resample is fixed point (the 8bpc
# path of Resample.c): horizontal pass first, coefficients rounded to
# 2^PRECISION_BITS, each pass accumulated in int32 with round-half-up and a
# clip to u8. The int32 arithmetic below is that arithmetic, so the bank is
# bit-equal to the host path.

PRECISION_BITS = 32 - 8 - 2  # PIL Resample.c 8bpc fixed point
_HALF = 1 << (PRECISION_BITS - 1)
WOUT_MAX = MAX_GRID * CROP  # 2688: widest supported landscape HD width


def pil_bilinear_taps(in_size: int, out_size: int, k_static: int):
    """PIL-parity bilinear tap table: (idx (out,), w (out, k_static) int32).

    idx[o] is the first source index of output o's taps; w rows are the
    fixed-point coefficients (sum 2^PRECISION_BITS), zero-padded to
    k_static. Mirrors precompute_coeffs + normalize_coeffs_8bpc."""
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = 1.0 * filterscale
    ksize = int(np.ceil(support)) * 2 + 1
    if ksize > k_static:
        raise ValueError(f"k_static {k_static} < required {ksize}")
    centers = (np.arange(out_size) + 0.5) * scale
    xmin = np.maximum((centers - support + 0.5).astype(np.int64), 0)
    xmax = np.minimum((centers + support + 0.5).astype(np.int64), in_size)
    taps = xmin[:, None] + np.arange(k_static)[None, :]
    dist = (taps - centers[:, None] + 0.5) / filterscale
    w = np.maximum(0.0, 1.0 - np.abs(dist))
    w = np.where(taps < xmax[:, None], w, 0.0)
    w = w / w.sum(axis=1, keepdims=True)
    wq = np.where(
        w < 0,
        (w * (1 << PRECISION_BITS) - 0.5).astype(np.int64),
        (w * (1 << PRECISION_BITS) + 0.5).astype(np.int64),
    )
    return xmin.astype(np.int32), wq.astype(np.int32)


def _fixedpoint_clip8(acc: torch.Tensor) -> torch.Tensor:
    """int32 accumulator (rounding half included) -> u8, PIL's clip8: an
    arithmetic shift, then a clip."""
    return (acc >> PRECISION_BITS).clamp(0, 255).to(torch.uint8)


def hd_resize_u8_bank(
    src_u8: torch.Tensor,  # (B, Hs, Ws, 3) u8, LANDSCAPE-oriented original
    hidx: torch.Tensor,  # (B, WOUT_MAX) int32 first horizontal tap
    hw: torch.Tensor,  # (B, WOUT_MAX, Kh) int32 fixed-point weights
    vidx: torch.Tensor,  # (B, nc, 336) int32 first vertical tap (source row)
    vw: torch.Tensor,  # (B, nc, 336, Kv) int32 (all zero on white-pad rows)
    vbias: torch.Tensor,  # (B, nc, 336) int32 rounding half (+255<<PB on pad rows)
    col_start: torch.Tensor,  # (B, nc) int32 first horizontal-output column of a slot
    slot_perm: torch.Tensor,  # (B, nc) int32 final-order -> landscape-order slots
    tflag: torch.Tensor,  # (B,) bool: portrait sample (transpose back)
) -> torch.Tensor:
    """uint8 original -> (B, nc, 336, 336, 3) uint8 HD crop bank, bit-equal
    to ``hd_transform_image`` + the crop split on the host. Every per-sample
    geometry lives in the host-built tap tables (``build_hd_resize_tables``)."""
    B, Hs, Ws, C = src_u8.shape
    nc = vidx.shape[1]
    Wout = hidx.shape[1]
    Kh, Kv = hw.shape[-1], vw.shape[-1]
    dev = src_u8.device
    # gather indices are int64 in torch; the arithmetic is PIL's int32
    hidx, vidx, col_start, slot_perm = (t.to(device=dev, dtype=torch.int64)
                                        for t in (hidx, vidx, col_start, slot_perm))
    hw, vw, vbias = (t.to(device=dev, dtype=torch.int32) for t in (hw, vw, vbias))
    src = src_u8.to(torch.int32)

    # pass 1: horizontal (PIL resamples horizontally first)
    acc = torch.full((B, Hs, Wout, C), _HALF, dtype=torch.int32, device=dev)
    for k in range(Kh):
        col = (hidx + k).clamp(0, Ws - 1)  # (B, Wout)
        taps = torch.gather(src, 2, col[:, None, :, None].expand(B, Hs, Wout, C))
        acc += taps * hw[:, None, :, k, None]
    hpass = _fixedpoint_clip8(acc).to(torch.int32)  # (B, Hs, Wout, 3)
    del acc

    # split the columns into slots before the vertical pass (its working set
    # shrinks from (.., WOUT_MAX, ..) to (.., 336, ..))
    cols = col_start[:, :, None] + torch.arange(CROP, device=dev)  # (B, nc, 336)
    slots = torch.gather(hpass[:, None].expand(B, nc, Hs, Wout, C), 3,
                         cols[:, :, None, :, None].expand(B, nc, Hs, CROP, C))
    del hpass

    # pass 2: vertical, the white padding folded into vbias
    acc = vbias[:, :, :, None, None].expand(B, nc, CROP, CROP, C).clone()
    for k in range(Kv):
        row = (vidx + k).clamp(0, Hs - 1)  # (B, nc, 336)
        taps = torch.gather(slots, 2, row[:, :, :, None, None].expand(B, nc, CROP, CROP, C))
        acc += taps * vw[:, :, :, None, k, None]
    bank = _fixedpoint_clip8(acc)  # (B, nc, 336, 336, 3) landscape order

    # portrait samples: permute the slots and swap each crop's spatial axes
    permuted = bank[torch.arange(B, device=dev)[:, None], slot_perm]
    tflag = tflag.to(device=dev, dtype=torch.bool)
    return torch.where(tflag[:, None, None, None, None], permuted.transpose(2, 3), bank)


def taps_for_bucket(bucket_edge: int) -> int:
    """Static tap count covering every downscale a bucket edge can ask for
    (worst support = bucket_edge/336; ksize = 2*ceil(support)+1)."""
    return 2 * math.ceil(max(bucket_edge / CROP, 1.0)) + 1


def build_hd_resize_tables(
    in_h: int,
    in_w: int,
    new_w: int,
    new_h: int,
    transposed: bool,
    num_crops: int,
    kh: int,
    kv: int,
):
    """Host-side (numpy) per-sample tap tables for ``hd_resize_u8_bank``.

    (in_h, in_w): the LANDSCAPE-oriented source size (the caller transposes
    the array of a portrait image); (new_w, new_h): ``hd_transform_scale``'s
    resize target. Returns a dict of unbatched arrays and the final (hc, wc)."""
    nc = num_crops
    target_h = int(math.ceil(new_h / CROP) * CROP)
    top = (target_h - new_h) // 2
    hcL, wcL = target_h // CROP, new_w // CROP
    if wcL * CROP > WOUT_MAX:
        raise ValueError(f"HD width {new_w} exceeds device budget {WOUT_MAX}")

    hx, hwt = pil_bilinear_taps(in_w, new_w, kh)
    hidx = np.zeros((WOUT_MAX,), np.int32)
    hw = np.zeros((WOUT_MAX, kh), np.int32)
    hidx[:new_w] = hx
    hw[:new_w] = hwt

    vx, vwt = pil_bilinear_taps(in_h, new_h, kv)
    vidx = np.zeros((nc, CROP), np.int32)
    vw = np.zeros((nc, CROP, kv), np.int32)
    vbias = np.full((nc, CROP), _HALF + (255 << PRECISION_BITS), np.int32)
    col_start = np.zeros((nc,), np.int32)
    for s in range(min(hcL * wcL, nc)):
        rL, cL = divmod(s, wcL)
        col_start[s] = cL * CROP
        g = rL * CROP + np.arange(CROP)
        inside = (g >= top) & (g < top + new_h)
        src_rows = np.clip(g - top, 0, new_h - 1)
        vidx[s] = np.where(inside, vx[src_rows], 0)
        vw[s] = np.where(inside[:, None], vwt[src_rows], 0)
        vbias[s] = np.where(inside, _HALF, vbias[s])

    slot_perm = np.arange(nc, dtype=np.int32)
    if transposed:
        hc, wc = wcL, hcL
        for r in range(hc):
            for c in range(wc):
                slot_perm[r * wc + c] = c * wcL + r
    else:
        hc, wc = hcL, wcL
    return {
        "hidx": hidx, "hw": hw, "vidx": vidx, "vw": vw, "vbias": vbias,
        "col_start": col_start, "slot_perm": slot_perm,
        "tflag": np.asarray(transposed),
    }, (hc, wc)
