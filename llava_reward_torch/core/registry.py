"""Model-family registry (the port's own copy of
``llava_reward_tpu/core/registry.py``): one place that knows how to build
configs, params, processors, datasets and LoRA targets per backbone, the
counterpart of the reference's dispatch on the model name
(rw_model_general_preference.py:113-159, reward_adaptor_loader.py:31-152,
train_llava_reward.py:27-50).

The phi3v and qwen processors ship uint8 pixels by default, prepared on the
card (``LRT_DEVICE_PREPROC=0`` opts out, as in the JAX package); LLaVA-NeXT's
anyres processor ships the host f32 bank.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Any, Callable, Optional, Tuple


@dataclass
class ModelFamily:
    name: str
    config_from_pretrain: Callable[[str], Any]
    tiny_config: Callable[[], Any]
    init_params: Callable  # (cfg, generator, dtype, device) -> backbone tree
    params_from_sd: Callable  # (sd, cfg, dtype) -> backbone tree
    make_processor: Callable  # (tokenizer, cfg) -> processor
    pairwise_dataset: Callable
    pointwise_dataset: Callable
    lora_targets: Tuple[str, ...]
    decoder_cfg: Callable[[Any], Any]
    get_projector: Callable[[dict], Optional[dict]]
    set_projector: Callable[[dict, dict], None]
    projector_path: Tuple[str, ...]  # slot in the backbone tree (train_step)
    supports_skipca: bool
    tokenizer_setup: Callable  # (tokenizer) -> None (padding side etc.)


def _device_preproc() -> bool:
    return os.environ.get("LRT_DEVICE_PREPROC", "1") != "0"


def _phi3v_family() -> ModelFamily:
    from ..data.datasets import PairwiseRewardDataset, PointwiseRewardDataset
    from ..evalx.adaptor import phi3v_config_from_pretrain
    from ..io.hf_phi3v import params_from_hf_state_dict
    from ..lora.lora import DEFAULT_TARGETS
    from ..models import phi3v
    from ..preprocess.phi3v_processor import Phi3VProcessor
    from .config import phi3v_tiny_config

    def set_proj(backbone, proj):
        backbone["vision"]["img_projection"] = proj

    def tok_setup(tok):
        # (utils/utils.py:19-27): left padding, right truncation, pad=eos
        tok.padding_side = "left"
        tok.truncation_side = "right"
        if getattr(tok, "pad_token", None) is None:
            tok.pad_token = tok.eos_token

    return ModelFamily(
        name="phi3v",
        config_from_pretrain=phi3v_config_from_pretrain,
        tiny_config=lambda: phi3v_tiny_config(num_crops=4),
        init_params=phi3v.init_params,
        params_from_sd=params_from_hf_state_dict,
        make_processor=lambda tok, cfg: Phi3VProcessor(
            tok, num_crops=cfg.num_crops, device_preproc=_device_preproc()),
        pairwise_dataset=PairwiseRewardDataset,
        pointwise_dataset=PointwiseRewardDataset,
        lora_targets=DEFAULT_TARGETS,
        decoder_cfg=lambda cfg: cfg.decoder,
        get_projector=lambda b: b["vision"]["img_projection"],
        set_projector=set_proj,
        projector_path=("vision", "img_projection"),
        supports_skipca=True,
        tokenizer_setup=tok_setup,
    )


def _qwen_family() -> ModelFamily:
    from ..data.datasets import QwenPairwiseRewardDataset, QwenPointwiseRewardDataset
    from ..evalx.adaptor import qwen_config_from_pretrain
    from ..io.hf_qwen import params_from_hf_state_dict
    from ..lora.lora import QWEN_TARGETS
    from ..models import qwen25_vl
    from ..preprocess.qwen_vision import Qwen25VLProcessor
    from .config import qwen_tiny_config

    def set_proj(backbone, proj):
        backbone["visual"]["merger"] = proj

    def make_proc(tok, cfg):
        return Qwen25VLProcessor(
            tok,
            patch_size=cfg.vision.patch_size,
            temporal_patch_size=cfg.vision.temporal_patch_size,
            merge_size=cfg.vision.spatial_merge_size,
            window_size=cfg.vision.window_size,
            min_pixels=cfg.min_pixels,
            max_pixels=cfg.max_pixels,
            image_token_id=cfg.text.image_token_id,
            device_preproc=_device_preproc(),
        )

    def tok_setup(tok):
        tok.padding_side = "left"
        tok.truncation_side = "right"

    return ModelFamily(
        name="qwen",
        config_from_pretrain=qwen_config_from_pretrain,
        tiny_config=qwen_tiny_config,
        init_params=qwen25_vl.init_params,
        params_from_sd=params_from_hf_state_dict,
        make_processor=make_proc,
        pairwise_dataset=QwenPairwiseRewardDataset,
        pointwise_dataset=QwenPointwiseRewardDataset,
        lora_targets=QWEN_TARGETS,
        decoder_cfg=lambda cfg: cfg.text,
        get_projector=lambda b: b["visual"]["merger"],
        set_projector=set_proj,
        projector_path=("visual", "merger"),
        supports_skipca=True,
        tokenizer_setup=tok_setup,
    )


def _llava_family() -> ModelFamily:
    from ..data.datasets import LlavaPairwiseRewardDataset, PointwiseRewardDataset
    from ..evalx.adaptor import llava_config_from_pretrain
    from ..io.hf_llava import params_from_hf_state_dict
    from ..lora.lora import QWEN_TARGETS
    from ..models import llava_next
    from ..preprocess.llava_processor import LlavaNextProcessor
    from .config import llava_tiny_config

    def set_proj(backbone, proj):
        backbone["vision"]["projector"] = proj

    def make_proc(tok, cfg):
        return LlavaNextProcessor(tok, image_token_id=cfg.text.image_token_id,
                                  grid_pinpoints=cfg.grid_pinpoints)

    def tok_setup(tok):
        tok.padding_side = "left"
        tok.truncation_side = "right"

    return ModelFamily(
        name="llava",
        config_from_pretrain=llava_config_from_pretrain,
        tiny_config=llava_tiny_config,
        init_params=llava_next.init_params,
        params_from_sd=params_from_hf_state_dict,
        make_processor=make_proc,
        pairwise_dataset=LlavaPairwiseRewardDataset,
        pointwise_dataset=PointwiseRewardDataset,
        lora_targets=QWEN_TARGETS,
        decoder_cfg=lambda cfg: cfg.text,
        get_projector=lambda b: b["vision"]["projector"],
        set_projector=set_proj,
        projector_path=("vision", "projector"),
        supports_skipca=False,  # not wired in the reference (rw:372-375)
        tokenizer_setup=tok_setup,
    )


_FAMILIES = {"phi3v": _phi3v_family, "qwen": _qwen_family, "llava": _llava_family}


def get_family(model_type: str) -> ModelFamily:
    try:
        make = _FAMILIES[model_type]
    except KeyError:
        raise ValueError(
            f"unknown model_type {model_type!r}; choose from {sorted(_FAMILIES)}"
        ) from None
    return make()
