"""Phi-3.5-V backbone forward (``llava_reward_tpu/models/phi3v.py``):
CLIP tower -> HD 2x2 merge -> sentinel-first feature bank -> gather ->
GELU projector -> static-shape splice into the text embeddings -> Phi-3
decoder.

The host precomputes, per sample, ``img_gather_idx`` (T_img,) into the
feature bank, ``splice_idx`` (S,) (image slot per position or -1) and
``num_img_tokens`` (valid slots); the device code is dense gathers and
selects over static shapes.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..core.config import Phi3VConfig
from ..core.device import DEFAULT_DEVICE, resolve_device
from ..ops.activations import gelu
from . import clip_vit, phi3


def init_params(
    cfg: Phi3VConfig,
    generator: torch.Generator,
    dtype: torch.dtype = torch.float32,
    device=DEFAULT_DEVICE,
) -> dict:
    """Random backbone tree drawn from ``generator`` on ``device`` (for a
    full-size bf16 model on the card, pass a CUDA generator and bf16)."""
    dev = resolve_device(device)
    D = cfg.merged_feature_dim
    H = cfg.decoder.hidden_size

    def dense(*shape):
        return torch.randn(*shape, generator=generator, device=dev, dtype=dtype).mul_(0.02)

    return {
        "decoder": phi3.init_params(cfg.decoder, generator, dtype, dev),
        "vision": {
            "clip": clip_vit.init_params(cfg.vision, generator, dtype, dev),
            "glb_GN": torch.zeros(D, device=dev, dtype=dtype),
            "sub_GN": torch.zeros(D, device=dev, dtype=dtype),
            "img_projection": {
                "fc1": {"kernel": dense(D, H), "bias": torch.zeros(H, device=dev, dtype=dtype)},
                "fc2": {"kernel": dense(H, H), "bias": torch.zeros(H, device=dev, dtype=dtype)},
            },
        },
    }


def merge_2x2(features: torch.Tensor, grid: int = 24) -> torch.Tensor:
    """(N, grid*grid, C) -> (N, (grid/2)^2, 4C); channel blocks are the 2x2
    spatial neighbours in row-major order (``phi3v.py:59-68``)."""
    N, L, C = features.shape
    g2 = grid // 2
    x = features.reshape(N, g2, 2, g2, 2, C).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(N, g2 * g2, 4 * C)


def vision_feature_bank(
    params: dict,
    cfg: Phi3VConfig,
    pixel_values: torch.Tensor,  # (B, num_crops+1, crop, crop, 3)
    *,
    attn_impl: str = "auto",
) -> torch.Tensor:
    """Dense merged-feature bank (B, 2 + NC*merge_grid^2, 4C): rows 0/1 are
    sub_GN/glb_GN (sentinels first), then every crop's merged patches."""
    B, NC, Himg, Wimg, C = pixel_values.shape
    feats = clip_vit.extract_patch_features(
        params["vision"]["clip"], cfg.vision,
        pixel_values.reshape(B * NC, Himg, Wimg, C), attn_impl=attn_impl,
    )
    grid = cfg.vision.image_size // cfg.vision.patch_size
    merged = merge_2x2(feats, grid)
    D = merged.shape[-1]
    bank = merged.reshape(B, NC * merged.shape[1], D)
    gns = torch.stack([params["vision"]["sub_GN"], params["vision"]["glb_GN"]]).to(bank.dtype)
    return torch.cat([gns[None].expand(B, 2, D), bank], dim=1)


class Phi3VOutput(NamedTuple):
    last_hidden_state: torch.Tensor  # (B, S, H) post final RMSNorm
    collected_hidden_state: Optional[torch.Tensor]
    vision_embedding: Optional[torch.Tensor]  # (B, T_img, H), zero on invalid slots


def _take_rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x (B, L, D), idx (B, T) -> (B, T, D) (``take_along_axis`` on axis 1)."""
    return torch.gather(x, 1, idx.long()[..., None].expand(-1, -1, x.shape[-1]))


def forward(
    params: dict,
    cfg: Phi3VConfig,
    input_ids: torch.Tensor,  # (B, S)
    attention_mask: torch.Tensor,  # (B, S) 1=valid
    position_ids: torch.Tensor,  # (B, S)
    pixel_values: Optional[torch.Tensor],  # (B, num_crops+1, crop, crop, 3)
    img_gather_idx: Optional[torch.Tensor],  # (B, T_img)
    splice_idx: Optional[torch.Tensor],  # (B, S) slot index or -1
    num_img_tokens: Optional[torch.Tensor],  # (B,)
    *,
    collect_layer_id: Optional[int] = None,
    attn_impl: str = "auto",
    lora: Optional[dict] = None,
) -> Phi3VOutput:
    embeds = params["decoder"]["embed_tokens"][input_ids.long()]
    dtype = embeds.dtype

    vision_embedding = None
    if pixel_values is not None:
        bank = vision_feature_bank(params, cfg, pixel_values.to(dtype), attn_impl=attn_impl)
        gathered = _take_rows(bank, img_gather_idx)
        proj = params["vision"]["img_projection"]
        x = gelu(gathered @ proj["fc1"]["kernel"] + proj["fc1"]["bias"])
        img_tokens = x @ proj["fc2"]["kernel"] + proj["fc2"]["bias"]
        # zero invalid slots (the reference's zero-padded per-image batch)
        slot = torch.arange(img_tokens.shape[1], device=img_tokens.device)[None, :]
        valid = (slot < num_img_tokens[:, None])[..., None]
        vision_embedding = torch.where(valid, img_tokens, torch.zeros((), dtype=img_tokens.dtype,
                                       device=img_tokens.device)).to(dtype)

        k = torch.clamp(splice_idx, 0, img_tokens.shape[1] - 1)
        spliced = _take_rows(vision_embedding, k)
        embeds = torch.where((splice_idx >= 0)[..., None], spliced, embeds)

    out = phi3.forward(
        params["decoder"], cfg.decoder, embeds, attention_mask, position_ids,
        collect_layer_id=collect_layer_id, attn_impl=attn_impl, lora=lora,
    )
    return Phi3VOutput(
        last_hidden_state=out.last_hidden_state,
        collected_hidden_state=out.collected_hidden_state,
        vision_embedding=vision_embedding,
    )
