"""LLaVA-v1.6 (LlavaNext) backbone (``llava_reward_tpu/models/llava_next.py``):
CLIP tower + anyres gather + projector + vicuna decoder.

Reference path: plain HF LlavaNextForConditionalGeneration forward with the
last hidden state only; SkipCA is not wired for llava
(rw_model_general_preference.py:372-375). The ragged
pack_image_features / unpad assembly is a host-precomputed gather over a
dense projected-feature bank (``preprocess/llava_processor.py``), and the
vicuna decoder is the qwen text stack (separate q/k/v/gate/up without
biases, standard rope through a degenerate M-RoPE section).

Param tree:
  {'vision': {'clip': <clip_vit tree>,
              'projector': {'fc1'|'fc2': {kernel, bias}},
              'image_newline': (H,)},
   'text': <qwen25_vl text tree (no qkv biases)>}
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..core.config import LlavaNextConfig
from ..core.device import DEFAULT_DEVICE, resolve_device
from ..ops.activations import ACT2FN
from ..ops.linear import mm
from . import clip_vit, qwen25_vl
from .phi3v import _take_rows


def init_params(
    cfg: LlavaNextConfig,
    generator: torch.Generator,
    dtype: torch.dtype = torch.float32,
    device=DEFAULT_DEVICE,
) -> dict:
    """Random backbone tree (normal, std 0.02) drawn from ``generator`` on
    ``device``; for the full-size bf16 model on the card, pass a CUDA
    generator and bf16."""
    dev = resolve_device(device)
    VH, H = cfg.vision.hidden_size, cfg.text.hidden_size

    def dense(*shape):
        return torch.randn(*shape, generator=generator, device=dev, dtype=dtype).mul_(0.02)

    text = qwen25_vl.init_text_params(cfg.text, generator, dtype, dev)
    for name in ("q_proj", "k_proj", "v_proj"):  # vicuna has no qkv biases
        text["layers"][name].pop("bias", None)
    return {
        "vision": {
            "clip": clip_vit.init_params(cfg.vision, generator, dtype, dev),
            "projector": {
                "fc1": {"kernel": dense(VH, H), "bias": torch.zeros(H, device=dev, dtype=dtype)},
                "fc2": {"kernel": dense(H, H), "bias": torch.zeros(H, device=dev, dtype=dtype)},
            },
            "image_newline": torch.zeros(H, device=dev, dtype=dtype),
        },
        "text": text,
    }


class LlavaOutput(NamedTuple):
    last_hidden_state: torch.Tensor
    collected_hidden_state: Optional[torch.Tensor]
    vision_embedding: Optional[torch.Tensor]  # (B, T_img, H), zero on invalid slots


def forward(
    params: dict,
    cfg: LlavaNextConfig,
    input_ids: torch.Tensor,  # (B, S)
    attention_mask: torch.Tensor,
    pixel_values: Optional[torch.Tensor],  # (B, 1+max_tiles, 336, 336, 3)
    img_gather_idx: Optional[torch.Tensor],  # (B, T_img) into the bank
    splice_idx: Optional[torch.Tensor],  # (B, S)
    num_img_tokens: Optional[torch.Tensor],  # (B,)
    *,
    collect_layer_id: Optional[int] = None,
    attn_impl: str = "auto",
    remat: bool = False,
    lora: Optional[dict] = None,
    tp=None,
) -> LlavaOutput:
    """``llava_next.py:62-123``. The projector's products go through
    ``ops/linear.mm``, so an fp32 trainable projector over bf16 features
    computes in fp32 as ``jnp.matmul`` does. Under ``tp`` the CLIP tower and
    the decoder run split; the projector is whole on every rank."""
    embeds = params["text"]["embed_tokens"][input_ids.long()]
    dtype = embeds.dtype

    vision_embedding = None
    if pixel_values is not None:
        B, NT, Hc, Wc, C = pixel_values.shape
        feats = clip_vit.extract_patch_features(
            params["vision"]["clip"], cfg.vision,
            pixel_values.reshape(B * NT, Hc, Wc, C).to(dtype),
            attn_impl=attn_impl, remat=remat, tp=tp,
        )  # (B*NT, 576, VH)
        proj = params["vision"]["projector"]
        act = ACT2FN[cfg.projector_hidden_act]
        x = act(mm(feats, proj["fc1"]["kernel"]) + proj["fc1"]["bias"])
        x = mm(x, proj["fc2"]["kernel"]) + proj["fc2"]["bias"]  # (B*NT, 576, H)
        H = x.shape[-1]
        bank = x.reshape(B, NT * x.shape[1], H)
        # the newline row leads (llava_processor.NEWLINE_IDX == 0): gather
        # indices stay valid when the collator pads the tile axis
        newline = params["vision"]["image_newline"].to(bank.dtype)[None, None, :].expand(B, 1, H)
        bank = torch.cat([newline, bank], dim=1)

        gathered = _take_rows(bank, img_gather_idx)
        slot = torch.arange(gathered.shape[1], device=gathered.device)[None, :]
        valid = (slot < num_img_tokens[:, None])[..., None]
        vision_embedding = torch.where(valid, gathered, torch.zeros(
            (), dtype=gathered.dtype, device=gathered.device)).to(dtype)

        k = torch.clamp(splice_idx, 0, vision_embedding.shape[1] - 1)
        spliced = _take_rows(vision_embedding, k)
        embeds = torch.where((splice_idx >= 0)[..., None], spliced, embeds)

    # vicuna: standard rope == degenerate M-RoPE; positions cumsum(mask) - 1
    # with pads set to 1
    pos1d = torch.cumsum(attention_mask.to(torch.int32), dim=-1) - 1
    pos1d = torch.where(attention_mask == 0, torch.ones_like(pos1d), pos1d)
    position_ids = pos1d[None].expand(3, *pos1d.shape)

    last, collected = qwen25_vl.text_forward(
        params["text"], cfg.text, embeds, attention_mask, position_ids,
        collect_layer_id=collect_layer_id, attn_impl=attn_impl, remat=remat, lora=lora, tp=tp,
    )
    return LlavaOutput(last, collected, vision_embedding)
