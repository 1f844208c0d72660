"""LLaVA-v1.6 (LlavaNext) host-side anyres preprocessing and static indices
(the port's own copy of ``llava_reward_tpu/preprocess/llava_processor.py``).

Reference behaviour reproduced (HF LlavaNextImageProcessor /
LlavaNextModel.pack_image_features, which the reference drives through
plain HF calls -- reward_dataset.py:267-350, rw_model...py:372-375):
- select_best_resolution over image_grid_pinpoints (max effective, min
  wasted resolution);
- aspect-preserving resize + centre pad to the best resolution, divide
  into 336x336 tiles; base image is a plain (squash) resize to 336x336;
- feature assembly [base 576 tokens] + [tile grid, unpadded to the
  original aspect, one image_newline per row];
- the single <image> token expands to the full image-token run.

The assembly is a host-precomputed gather over a dense per-image feature
bank [(1+max_tiles) tiles x 576 projected features] after a leading
newline row, the same machinery as Phi3V's HD transform. Anyres keeps the
host f32 bank: its samples carry no ``crop_grid``, so the collator takes
them on its f32 path.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np

from ..ops.pixels import OPENAI_CLIP_MEAN, OPENAI_CLIP_STD

DEFAULT_GRID_PINPOINTS = (
    (336, 672), (672, 336), (672, 672), (1008, 336), (336, 1008),
)


def select_best_resolution(
    original_size: Tuple[int, int], possible: Sequence[Tuple[int, int]]
) -> Tuple[int, int]:
    """(height, width) maximising effective and minimising wasted resolution
    (HF image_processing_utils.select_best_resolution)."""
    oh, ow = original_size
    best = None
    max_eff = 0
    min_waste = float("inf")
    for h, w in possible:
        scale = min(w / ow, h / oh)
        dw, dh = int(ow * scale), int(oh * scale)
        eff = min(dw * dh, ow * oh)
        waste = h * w - eff
        if eff > max_eff or (eff == max_eff and waste < min_waste):
            max_eff, min_waste, best = eff, waste, (h, w)
    return best


def _patch_output_size(oh: int, ow: int, th: int, tw: int) -> Tuple[int, int]:
    scale_w, scale_h = tw / ow, th / oh
    if scale_w < scale_h:
        return min(math.ceil(oh * scale_w), th), tw
    return th, min(math.ceil(ow * scale_h), tw)


def _unpad_range(cur: int, new: int) -> Tuple[int, int]:
    """unpad_image slice bounds: [pad, cur - pad) with pad = (cur-new)//2."""
    pad = (cur - new) // 2
    return pad, cur - pad


def anyres_feature_geometry(
    orig_h: int,
    orig_w: int,
    grid_pinpoints=DEFAULT_GRID_PINPOINTS,
    tile: int = 336,
    feat: int = 24,
) -> dict:
    """All the data-dependent geometry, resolved on host."""
    bh, bw = select_best_resolution((orig_h, orig_w), grid_pinpoints)
    nh, nw = bh // tile, bw // tile
    ch, cw = nh * feat, nw * feat  # feature-grid dims before unpad
    # unpad_image on the (C, ch, cw) feature grid
    if orig_w / orig_h > cw / ch:
        new_h = int(round(orig_h * (cw / orig_w), 7))
        r0, r1 = _unpad_range(ch, new_h)
        c0, c1 = 0, cw
    else:
        new_w = int(round(orig_w * (ch / orig_h), 7))
        c0, c1 = _unpad_range(cw, new_w)
        r0, r1 = 0, ch
    return {
        "best": (bh, bw),
        "tiles": (nh, nw),
        "rows": (r0, r1),
        "cols": (c0, c1),
    }


def num_image_tokens(orig_h: int, orig_w: int, grid_pinpoints=DEFAULT_GRID_PINPOINTS) -> int:
    g = anyres_feature_geometry(orig_h, orig_w, grid_pinpoints)
    h = g["rows"][1] - g["rows"][0]
    w = g["cols"][1] - g["cols"][0]
    return 576 + h * (w + 1)


def max_image_tokens(grid_pinpoints=DEFAULT_GRID_PINPOINTS) -> int:
    """Worst case over pinpoints: square fills have no unpad."""
    best = 0
    for h, w in grid_pinpoints:
        nh, nw = h // 336, w // 336
        best = max(best, 576 + (nh * 24) * (nw * 24 + 1))
    return best


def max_tiles(grid_pinpoints=DEFAULT_GRID_PINPOINTS) -> int:
    return max((h // 336) * (w // 336) for h, w in grid_pinpoints)


NEWLINE_IDX = 0  # the newline row LEADS the bank (sentinel-rows-lead, like
# phi3v's crop bank) so gather indices are invariant to how many tiles the
# collator pads the crop axis to — required for multi-image / mixed batches


def anyres_token_indices(
    orig_h: int,
    orig_w: int,
    grid_pinpoints=DEFAULT_GRID_PINPOINTS,
    feat: int = 24,
    tile_offset: int = 0,
) -> List[int]:
    """Token->bank-row indices for ONE image whose tiles start at
    ``tile_offset`` in the concatenated crop axis. Bank layout: row 0 =
    newline, then tile t's feature (i, j) at 1 + t*feat^2 + i*feat + j.
    Token order matches pack_image_features: [base (tile 0, row-major)]
    then the unpadded tile grid row-major with a newline after each row."""
    g = anyres_feature_geometry(orig_h, orig_w, grid_pinpoints)
    nh, nw = g["tiles"]
    r0, r1 = g["rows"]
    c0, c1 = g["cols"]

    def row(t, i, j):
        return 1 + (tile_offset + t) * feat * feat + i * feat + j

    toks: List[int] = [row(0, i, j) for i in range(feat) for j in range(feat)]
    for r in range(r0, r1):
        for c in range(c0, c1):
            t = 1 + (r // feat) * nw + (c // feat)
            toks.append(row(t, r % feat, c % feat))
        toks.append(NEWLINE_IDX)
    return toks


def build_anyres_gather_idx(
    orig_h: int,
    orig_w: int,
    budget: int,
    grid_pinpoints=DEFAULT_GRID_PINPOINTS,
    feat: int = 24,
) -> Tuple[np.ndarray, int]:
    toks = anyres_token_indices(orig_h, orig_w, grid_pinpoints, feat)
    n = len(toks)
    if n > budget:
        raise ValueError(f"image tokens {n} exceed budget {budget}")
    out = np.full((budget,), NEWLINE_IDX, dtype=np.int32)
    out[:n] = np.asarray(toks, np.int32)
    return out, n


def preprocess_image_anyres(
    image, grid_pinpoints=DEFAULT_GRID_PINPOINTS, tile: int = 336
) -> Tuple[np.ndarray, Tuple[int, int]]:
    """PIL -> (1 + max_tiles, 336, 336, 3) float32 [base, tiles..., pad0],
    CLIP-normalised channels-last, plus the original (h, w)."""
    from PIL import Image

    img = image.convert("RGB")
    ow, oh = img.size
    bh, bw = select_best_resolution((oh, ow), grid_pinpoints)
    nh, nw = bh // tile, bw // tile

    rh, rw = _patch_output_size(oh, ow, bh, bw)
    resized = np.asarray(img.resize((rw, rh), Image.BICUBIC), np.float32)
    top = (bh - rh) // 2
    left = (bw - rw) // 2
    canvas = np.zeros((bh, bw, 3), np.float32)
    canvas[top : top + rh, left : left + rw] = resized

    def norm(x):
        return ((x / 255.0) - OPENAI_CLIP_MEAN) / OPENAI_CLIP_STD

    T = max_tiles(grid_pinpoints)
    out = np.zeros((1 + T, tile, tile, 3), np.float32)
    out[0] = norm(np.asarray(img.resize((tile, tile), Image.BICUBIC), np.float32))
    k = 1
    for i in range(nh):
        for j in range(nw):
            out[k] = norm(canvas[i * tile : (i + 1) * tile, j * tile : (j + 1) * tile])
            k += 1
    return out, (oh, ow)


@dataclass
class LlavaProcessedSample:
    family = "llava"  # anyres tiles: no phi3v crop-bucketing in the collator

    input_ids: np.ndarray
    attention_mask: np.ndarray
    splice_idx: np.ndarray
    pixel_values: Optional[np.ndarray]  # (1+max_tiles, 336, 336, 3)
    img_gather_idx: Optional[np.ndarray]  # (budget,)
    num_img_tokens: int
    image_size: Tuple[int, int]  # original (h, w)


class LlavaNextProcessor:
    """Tokenizer + anyres image processor; the prompt must contain one
    ``<image>`` placeholder token."""

    def __init__(
        self,
        tokenizer,
        image_token_id: int = 32000,
        grid_pinpoints=DEFAULT_GRID_PINPOINTS,
        img_token_budget: Optional[int] = None,
    ):
        self.tokenizer = tokenizer
        self.image_token_id = image_token_id
        self.grid_pinpoints = tuple(tuple(p) for p in grid_pinpoints)
        self.img_token_budget = (
            img_token_budget
            if img_token_budget is not None
            else max_image_tokens(self.grid_pinpoints)
        )

    def _tokenize(self, text: str) -> List[int]:
        out = self.tokenizer(text)
        if hasattr(out, "input_ids"):
            return list(out.input_ids)
        if isinstance(out, dict):
            return list(out["input_ids"])
        return list(out)

    def __call__(self, text: str, images: Sequence = ()) -> LlavaProcessedSample:
        ids = np.asarray(self._tokenize(text), dtype=np.int32)
        if not images:
            return LlavaProcessedSample(
                ids, np.ones_like(ids), np.full_like(ids, -1), None, None, 0, (0, 0)
            )
        # Multi-image: one <image> token per image in prompt order; each
        # image's (1+max_tiles) bank concatenates along the crop axis and
        # its gather indices offset by the preceding images' tiles
        # (HF pack_image_features iterates image_features per image).
        pos = np.nonzero(ids == self.image_token_id)[0]
        assert len(pos) == len(images), (
            f"prompt has {len(pos)} <image> tokens for {len(images)} images"
        )
        tiles_per_img = 1 + max_tiles(self.grid_pinpoints)
        budget = self.img_token_budget
        if len(images) > 1:
            budget = budget * len(images)

        banks, sizes, toks_per_img = [], [], []
        for i, image in enumerate(images):
            bank, (oh, ow) = preprocess_image_anyres(image, self.grid_pinpoints)
            banks.append(bank)
            sizes.append((oh, ow))
            toks_per_img.append(
                anyres_token_indices(
                    oh, ow, self.grid_pinpoints, tile_offset=i * tiles_per_img
                )
            )

        gidx = np.full((budget,), NEWLINE_IDX, np.int32)
        all_toks = [t for toks in toks_per_img for t in toks]
        if len(all_toks) > budget:
            raise ValueError(f"image tokens {len(all_toks)} exceed budget {budget}")
        gidx[: len(all_toks)] = np.asarray(all_toks, np.int32)

        # expand each <image> token to its run; global token slots are
        # consecutive across images
        segs, splice_segs = [], []
        cursor = 0
        slot_base = 0
        for p, toks in zip(pos, toks_per_img):
            n_i = len(toks)
            segs.append(ids[cursor:p])
            splice_segs.append(np.full(p - cursor, -1, np.int32))
            segs.append(np.zeros(n_i, np.int32))
            splice_segs.append(slot_base + np.arange(n_i, dtype=np.int32))
            slot_base += n_i
            cursor = p + 1
        segs.append(ids[cursor:])
        splice_segs.append(np.full(len(ids) - cursor, -1, np.int32))
        ids = np.concatenate(segs).astype(np.int32)
        splice = np.concatenate(splice_segs)

        return LlavaProcessedSample(
            input_ids=ids,
            attention_mask=np.ones_like(ids),
            splice_idx=splice,
            pixel_values=np.concatenate(banks, axis=0),
            img_gather_idx=gidx,
            num_img_tokens=slot_base,
            image_size=sizes[0] if len(sizes) == 1 else sizes,
        )


def apply_llava_chat_template(tokenizer, prompt: str) -> str:
    """Prompt construction for the llava dataset (reward_dataset.py:267-290:
    chat template sliced [0:-11] + EOS)."""
    msg = {"role": "user", "content": f"<image>\n{prompt}"}
    templated = tokenizer.apply_chat_template(
        [msg], tokenize=False, add_generation_prompt=True
    )[0:-11]
    return templated + tokenizer.eos_token
