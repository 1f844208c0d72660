"""Pure-numpy Phi-3.5-V image-token geometry (the port's own copy of
``llava_reward_tpu/preprocess/phi3v_processor.py:80-140``).

The image pipeline itself (HD transform, resampling, tokenised splicing)
arrives with the serving slice (ROADMAP slice 3).
"""

from __future__ import annotations

import numpy as np


def num_img_tokens_for(h: int, w: int) -> int:
    """h, w are the padded HD sizes (multiples of 336)."""
    hc, wc = h // 336, w // 336
    return int((hc * wc + 1) * 144 + 1 + (hc + 1) * 12)


def build_img_gather_idx(
    h_crop: int, w_crop: int, num_crops: int, budget: int, merge_grid: int = 12
) -> np.ndarray:
    """Indices into the dense feature bank for one image's token sequence.

    Bank layout (models/phi3v.py): rows 0/1 are sub_GN/glb_GN; crop c's
    merged patch (i, j) lives at ``2 + c*G^2 + i*G + j``. Order: sub crops
    row-major with a newline (sub_GN) after each of the h_crop*G rows, then
    glb_GN, then the global crop (index 0) with its newlines.
    """
    G = merge_grid
    g2 = G * G
    sub_gn, glb_gn = 0, 1
    base = 2

    R = np.arange(h_crop * G)[:, None]
    Cc = np.arange(w_crop * G)[None, :]
    crop = 1 + (R // G) * w_crop + (Cc // G)
    idx_grid = base + crop * g2 + (R % G) * G + (Cc % G)
    rows = np.concatenate(
        [idx_grid, np.full((h_crop * G, 1), sub_gn, dtype=np.int64)], axis=1
    ).reshape(-1)

    gi = np.arange(G)[:, None]
    gj = np.arange(G)[None, :]
    glb_grid = base + gi * G + gj
    glb_rows = np.concatenate(
        [glb_grid, np.full((G, 1), sub_gn, dtype=np.int64)], axis=1
    ).reshape(-1)

    idx = np.concatenate([rows, np.array([glb_gn], dtype=np.int64), glb_rows])
    n = idx.shape[0]
    if G == 12 and n != num_img_tokens_for(h_crop * 336, w_crop * 336):
        raise ValueError(f"token count {n} disagrees with the formula ({h_crop}, {w_crop})")
    if n > budget:
        raise ValueError(f"image token count {n} exceeds budget {budget}")
    out = np.full((budget,), sub_gn, dtype=np.int32)
    out[:n] = idx
    return out
