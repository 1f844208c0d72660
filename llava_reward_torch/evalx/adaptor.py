"""Scoring entry point (``llava_reward_tpu/evalx/adaptor.py:201-233``).

``RewardAdaptor`` holds the configs, the param tree and the device;
``make_score_fn`` returns the function that answers scoring requests,
memoised per ``(attn_impl, training)`` as in the JAX package.
``model_type`` is ``"phi3v"``, ``"qwen"`` or ``"llava"``; a qwen or llava
tree may be in the fused-projection layout
(``models/qwen25_vl.fuse_decoder_projections``, as ``load_reward_adaptor``
leaves it) or the separate one. ``merge_for_scoring`` is the tail of the JAX
package's ``load_reward_adaptor`` (``adaptor.py:380-489``): a trained LoRA
folded into the decoder, a trained projector put in its slot, and for qwen
and llava the projections fused, so that the scoring route reads what
training wrote.

``load_reward_adaptor`` rebuilds a reward model from a base checkpoint
directory and a reward artifact (``adaptor.py:292-516``, the contract of
eval/reward_adaptor_loader.py:24-152): reward_config.yaml, the configs from
the base checkpoint's config.json, strict key checks, the PEFT adapter
merged at load, the heads and projector from pytorch_model.bin, then an
optional quantization of the decoder and a cast. The configs of
``*_config_from_pretrain`` are the JAX package's, field for field.
"""

from __future__ import annotations

import dataclasses
import json
import os
import re
from dataclasses import dataclass, field
from typing import Callable, Dict, Optional, Tuple, Union

import torch

from ..core.config import (DecoderConfig, LlavaNextConfig, Phi3VConfig, Qwen25VLConfig,
                           QwenTextConfig, QwenVisionConfig, RewardConfig, RopeScalingConfig,
                           VisionConfig, phi35_vision_config, qwen25_vl_7b_config)
from ..core.device import DEFAULT_DEVICE, resolve_device
from ..io.artifact import (check_artifact_keys, load_head_params, load_llava_projector_params,
                           load_projector_params, load_qwen_merger_params, load_reward_config)
from ..io.hf_llava import params_from_hf_state_dict as llava_params
from ..io.hf_phi3v import params_from_hf_state_dict as phi3v_params
from ..io.hf_qwen import params_from_hf_state_dict as qwen_params
from ..io.torch_io import load_torch_state_dict
from ..lora.lora import (_PEFT_PATH, _VISION_PEFT_PATH, _VISION_PEFT_PREFIX, DEFAULT_TARGETS,
                         QWEN_TARGETS, merge_lora, merge_vision_lora, peft_state_to_stacked,
                         vision_peft_state_to_stacked)
from ..models.qwen25_vl import fuse_decoder_projections
from ..reward.model import RewardBatch, reward_forward
from ..train.optim import tree_map
from ..utils.quantize import is_quantized, is_w8a8, quantize_stacked_layers


def _to_device(x, device):
    if x is None:
        return None
    if isinstance(x, dict):  # the device-resize tap tables
        return {k: _to_device(v, device) for k, v in x.items()}
    return torch.as_tensor(x).to(device)


def batch_to_device(batch: RewardBatch, device: torch.device) -> RewardBatch:
    """Numpy / tensor batch fields -> tensors on ``device``."""
    return RewardBatch(*[_to_device(x, device) for x in batch])


# per family: (vision subtree, decoder subtree, projector slot)
_SLOTS = {"phi3v": ("vision", "decoder", "img_projection"),
          "qwen": ("visual", "text", "merger"),
          "llava": ("vision", "text", "projector")}
_CONFIGS = {"phi3v": Phi3VConfig, "qwen": Qwen25VLConfig, "llava": LlavaNextConfig}


def merge_for_scoring(backbone: dict, model_type: str, lora: Optional[dict] = None,
                      projector: Optional[dict] = None) -> dict:
    """The backbone tree a trained artifact scores with: ``lora`` (a stacked
    tree, e.g. ``peft_state_to_stacked`` of the artifact's adapter) merged
    into the decoder's layers in their dtype, ``projector`` (phi3v's
    ``img_projection``, qwen's merger or llava's projector) in its slot, and a
    qwen or llava decoder in the fused inference layout
    (``adaptor.py:479-487``), which takes no adapters and so comes after the
    merge. The input tree is not modified."""
    vis, dec, slot = _SLOTS[model_type]
    out = dict(backbone)
    layers = out[dec]["layers"]
    if lora is not None:
        layers = merge_lora(layers, lora)
    if model_type in ("qwen", "llava"):
        layers = fuse_decoder_projections(layers)
    out[dec] = {**out[dec], "layers": layers}
    if projector is not None:
        like = out[vis][slot]["fc1"]["kernel"]  # the slot's device and dtype
        out[vis] = {**out[vis], slot: tree_map(
            lambda t: t.to(device=like.device, dtype=like.dtype), projector)}
    return out


@dataclass
class RewardAdaptor:
    """Model + configs on one device; ``device`` defaults to ``"cuda"`` and
    raises where there is none."""

    cfg: Union[Phi3VConfig, Qwen25VLConfig, LlavaNextConfig]
    rcfg: RewardConfig
    params: dict  # {'backbone': ..., 'head': ...}
    model_type: str = "phi3v"
    device: Union[str, torch.device] = DEFAULT_DEVICE
    _score_fns: Dict[Tuple[str, bool], Callable] = field(default_factory=dict, repr=False)

    def __post_init__(self):
        self.device = resolve_device(self.device)
        want = _CONFIGS.get(self.model_type)
        if want is None:
            raise ValueError(f"unknown model_type {self.model_type!r}; choose from "
                             f"{sorted(_CONFIGS)}")
        if not isinstance(self.cfg, want):
            raise ValueError(f"model_type {self.model_type!r} takes a {want.__name__}, "
                             f"got {type(self.cfg).__name__}")

    def make_score_fn(self, attn_impl: str = "auto", training: bool = False):
        """``score(params, batch) -> (B, value_head_dim)`` rewards. Batch
        fields may be numpy arrays or tensors; they move to the adaptor's
        device."""
        key = (attn_impl, training)
        if key in self._score_fns:
            return self._score_fns[key]
        cfg, rcfg, device = self.cfg, self.rcfg, self.device

        @torch.inference_mode()
        def score(params: dict, batch: RewardBatch) -> torch.Tensor:
            return reward_forward(
                params, cfg, rcfg, batch_to_device(batch, device),
                training=training, attn_impl=attn_impl,
            ).reward

        self._score_fns[key] = score
        return score


# ------------------------------------------------------------------ configs


def decoder_config_from_hf_json(cfg_json: dict) -> DecoderConfig:
    """Phi3V config.json -> DecoderConfig (configuration_phi3_v.py:120-217)."""
    scaling = None
    rs = cfg_json.get("rope_scaling")
    if rs:
        scaling = RopeScalingConfig(
            rope_type=rs.get("type", "su"),
            short_factor=tuple(rs["short_factor"]),
            long_factor=tuple(rs["long_factor"]),
        )
    return DecoderConfig(
        vocab_size=cfg_json.get("vocab_size", 32064),
        hidden_size=cfg_json.get("hidden_size", 3072),
        intermediate_size=cfg_json.get("intermediate_size", 8192),
        num_layers=cfg_json.get("num_hidden_layers", 32),
        num_heads=cfg_json.get("num_attention_heads", 32),
        num_kv_heads=cfg_json.get("num_key_value_heads", 32),
        rms_norm_eps=cfg_json.get("rms_norm_eps", 1e-5),
        rope_theta=cfg_json.get("rope_theta", 10000.0),
        max_position_embeddings=cfg_json.get("max_position_embeddings", 131072),
        original_max_position_embeddings=cfg_json.get("original_max_position_embeddings", 4096),
        rope_scaling=scaling,
        sliding_window=cfg_json.get("sliding_window"),
        pad_token_id=cfg_json.get("pad_token_id", 32000),
        eos_token_id=cfg_json.get("eos_token_id", 32000),
    )


_CLIP = "model.vision_embed_tokens.img_processor.vision_model"


def _infer_vision_geometry(cfg: Phi3VConfig, sd: dict) -> Phi3VConfig:
    """The CLIP tower is hard-coded in the reference (modeling_phi3_v.py:68)
    and absent from config.json: its layer count and widths are read off the
    weights, so tiny and synthetic checkpoints load too."""
    layer_ids = {int(m.group(1)) for k in sd
                 for m in [re.match(rf"{re.escape(_CLIP)}\.encoder\.layers\.(\d+)\.", k)] if m}
    if not layer_ids:
        return cfg
    hidden = sd[f"{_CLIP}.embeddings.class_embedding"].reshape(-1).shape[0]
    inter = sd[f"{_CLIP}.encoder.layers.0.mlp.fc1.weight"].shape[0]
    vision = dataclasses.replace(cfg.vision, num_layers=max(layer_ids) + 1, hidden_size=hidden,
                                 intermediate_size=inter)
    return dataclasses.replace(cfg, vision=vision, image_dim_out=hidden)


def _read_json(pretrain: str) -> Optional[dict]:
    path = os.path.join(pretrain, "config.json")
    if not os.path.exists(path):
        return None
    with open(path) as f:
        return json.load(f)


def phi3v_config_from_pretrain(pretrain: str) -> Phi3VConfig:
    cj = _read_json(pretrain)
    if cj is None:
        return phi35_vision_config()
    return Phi3VConfig(decoder=decoder_config_from_hf_json(cj), vision=VisionConfig())


def llava_config_from_pretrain(pretrain: str) -> LlavaNextConfig:
    """config.json -> LlavaNextConfig (nested text_config / vision_config;
    ``adaptor.py:105-150``)."""
    cj = _read_json(pretrain)
    if cj is None:
        return LlavaNextConfig()
    tj = cj.get("text_config", {})
    vj = cj.get("vision_config", {})
    hd = tj.get("hidden_size", 5120) // tj.get("num_attention_heads", 40)
    text = QwenTextConfig(
        vocab_size=tj.get("vocab_size", 32064),
        hidden_size=tj.get("hidden_size", 5120),
        intermediate_size=tj.get("intermediate_size", 13824),
        num_layers=tj.get("num_hidden_layers", 40),
        num_heads=tj.get("num_attention_heads", 40),
        num_kv_heads=tj.get("num_key_value_heads", tj.get("num_attention_heads", 40)),
        rms_norm_eps=tj.get("rms_norm_eps", 1e-5),
        rope_theta=tj.get("rope_theta", 10000.0),
        max_position_embeddings=tj.get("max_position_embeddings", 4096),
        mrope_section=(hd // 2, 0, 0),
        pad_token_id=tj.get("pad_token_id") or 0,
        eos_token_id=tj.get("eos_token_id", 2),
        image_token_id=cj.get("image_token_index", 32000),
    )
    vision = VisionConfig(
        hidden_size=vj.get("hidden_size", 1024),
        intermediate_size=vj.get("intermediate_size", 4096),
        num_layers=vj.get("num_hidden_layers", 24),
        num_heads=vj.get("num_attention_heads", 16),
        image_size=vj.get("image_size", 336),
        patch_size=vj.get("patch_size", 14),
        feature_layer_idx=cj.get("vision_feature_layer", -2),
    )
    pins = cj.get("image_grid_pinpoints",
                  [[336, 672], [672, 336], [672, 672], [1008, 336], [336, 1008]])
    return LlavaNextConfig(text=text, vision=vision, grid_pinpoints=tuple(tuple(p) for p in pins))


def qwen_config_from_pretrain(pretrain: str) -> Qwen25VLConfig:
    """config.json -> Qwen25VLConfig; flat (4.50-era) and nested text_config
    layouts alike."""
    cj = _read_json(pretrain)
    if cj is None:
        return qwen25_vl_7b_config()
    tj = cj.get("text_config", cj)
    vj = cj.get("vision_config", {})
    rs = tj.get("rope_scaling") or cj.get("rope_scaling") or {}
    text = QwenTextConfig(
        vocab_size=tj.get("vocab_size", 152064),
        hidden_size=tj.get("hidden_size", 3584),
        intermediate_size=tj.get("intermediate_size", 18944),
        num_layers=tj.get("num_hidden_layers", 28),
        num_heads=tj.get("num_attention_heads", 28),
        num_kv_heads=tj.get("num_key_value_heads", 4),
        rms_norm_eps=tj.get("rms_norm_eps", 1e-6),
        rope_theta=tj.get("rope_theta", 1000000.0),
        max_position_embeddings=tj.get("max_position_embeddings", 128000),
        mrope_section=tuple(rs.get("mrope_section", (16, 24, 24))),
        sliding_window=tj.get("sliding_window") if tj.get("use_sliding_window", False) else None,
        pad_token_id=tj.get("pad_token_id") or 151643,
        eos_token_id=tj.get("eos_token_id", 151645),
        image_token_id=cj.get("image_token_id", 151655),
    )
    vision = QwenVisionConfig(
        depth=vj.get("depth", 32),
        hidden_size=vj.get("hidden_size", 1280),
        intermediate_size=vj.get("intermediate_size", 3420),
        num_heads=vj.get("num_heads", 16),
        patch_size=vj.get("patch_size", 14),
        temporal_patch_size=vj.get("temporal_patch_size", 2),
        spatial_merge_size=vj.get("spatial_merge_size", 2),
        window_size=vj.get("window_size", 112),
        fullatt_block_indexes=tuple(vj.get("fullatt_block_indexes", (7, 15, 23, 31))),
        out_hidden_size=vj.get("out_hidden_size", 3584),
    )
    return Qwen25VLConfig(text=text, vision=vision)


# ------------------------------------------------------------------ loading


def _merge_projector_lora(proj: dict, lora_sd: dict, alpha: float, rank: int) -> bool:
    """Merge img_projection.{0,2} LoRA (a reference unfrozen-vision target,
    utils/utils.py:211-212) into the projector's fc1 / fc2 kernels. PEFT
    stores lora_A (r, in) and lora_B (out, r); the delta B @ A is (out, in),
    the tree's its transpose. True if any key was merged."""
    merged = False
    for idx, fc in (("0", "fc1"), ("2", "fc2")):
        a = b = None
        for k, v in lora_sd.items():
            if f"img_projection.{idx}.lora_A" in k:
                a = v
            elif f"img_projection.{idx}.lora_B" in k:
                b = v
        if a is None or b is None:
            continue
        kern = proj[fc]["kernel"]
        delta = (alpha / rank) * (b.float() @ a.float()).T  # (in, out)
        proj[fc]["kernel"] = kern + delta.to(device=kern.device, dtype=kern.dtype)
        merged = True
    return merged


def _check_lora_consumed(lora_sd, targets, vision_merged, proj_merged, *, strict: bool = True):
    """Refuse adapter keys that no merge consumed (e.g. a PEFT adapter trained
    on modules this loader does not know): the reference's load_adapter is
    strict too."""
    dec_paths = [_PEFT_PATH[t] for t in targets]

    def consumed(k):
        if _VISION_PEFT_PREFIX in k:
            return vision_merged and any(f"{p}.lora_" in k for p in _VISION_PEFT_PATH.values())
        if "img_projection." in k:
            return proj_merged
        return ".layers." in k and any(f"{p}.lora_" in k for p in dec_paths)

    extra = sorted(k for k in lora_sd if not consumed(k))
    if not extra:
        return
    shown = ", ".join(extra[:8]) + (" ..." if len(extra) > 8 else "")
    msg = (f"{len(extra)} unconsumed LoRA adapter key(s): [{shown}] — these deltas would be "
           "silently dropped. Pass strict=False to downgrade this to a warning.")
    if strict:
        raise ValueError(msg)
    from ..core.logging import init_logger

    init_logger(__name__).warning(msg)


def cast_params(tree, dtype):
    """Float leaves to ``dtype``; quantized leaf dicts keep their codes and
    fp32 scales."""
    if isinstance(tree, dict):
        if is_quantized(tree) or is_w8a8(tree):
            return tree
        return {k: cast_params(v, dtype) for k, v in tree.items()}
    return tree.to(dtype) if tree.is_floating_point() else tree


def load_reward_adaptor(
    pretrain: str,
    pm_path: str,
    model_type: str = "phi3v",
    dtype: torch.dtype = torch.float32,
    ft_projector: bool = True,
    compute_dtype: Optional[torch.dtype] = None,
    quantize: Optional[str] = None,
    quantize_min_size: int = 1 << 20,
    strict: bool = True,
    device=DEFAULT_DEVICE,
) -> RewardAdaptor:
    """Rebuild the reward model from a base checkpoint dir and a reward
    artifact, on ``device``.

    ``strict``: refuse state-dict keys the mapping never consumes (and
    artifact / LoRA keys no loader family matches), as strict load_state_dict
    does (reward_adaptor_loader.py:46-63); False downgrades them to warnings.
    ``dtype``: the dtype the checkpoint is read and merged in.
    ``compute_dtype``: the dtype the float leaves are cast to at the end
    (e.g. torch.bfloat16, the reference's torch_dtype at
    reward_adaptor_loader.py:36). ``quantize``: the decoder's projections
    after the LoRA merge (the adapter rides inside the quantized weights):
    'w8a8' (the card's int8 GEMM, --load_in_8bit) or weight-only 'int8',
    'int4', 'nf4' (--load_in_4bit). The vision towers stay unquantized under
    every scheme, as in the JAX package (``adaptor.py:460-470``).
    """
    dev = resolve_device(device)
    if model_type not in _SLOTS:
        raise ValueError(f"unknown model_type {model_type!r}; choose from {sorted(_SLOTS)}")
    rcfg = load_reward_config(pm_path)
    sd = load_torch_state_dict(pretrain)

    # full-checkpoint mode (batch_inference_rm_ft_phi.py:28-55): pretrain IS
    # the artifact (the dir, or its pytorch_model.bin), so its one .bin holds
    # backbone AND reward-head keys; only then does the base strict check
    # leave the head keys alone
    full_ckpt = os.path.realpath(pretrain) in (
        os.path.realpath(pm_path), os.path.realpath(os.path.join(pm_path, "pytorch_model.bin")))
    cfg_dir = os.path.dirname(pretrain) if os.path.isfile(pretrain) else pretrain

    if model_type == "phi3v":
        cfg = _infer_vision_geometry(phi3v_config_from_pretrain(cfg_dir), sd)
        backbone = phi3v_params(sd, cfg, dtype=dtype, strict=strict, ignore_head_keys=full_ckpt)
        decoder_cfg, default_targets = cfg.decoder, DEFAULT_TARGETS
    else:
        cfg, load = ((qwen_config_from_pretrain(cfg_dir), qwen_params) if model_type == "qwen"
                     else (llava_config_from_pretrain(cfg_dir), llava_params))
        backbone = load(sd, cfg, dtype=dtype, strict=strict, ignore_head_keys=full_ckpt)
        decoder_cfg, default_targets = cfg.text, QWEN_TARGETS
    del sd
    backbone = tree_map(lambda t: t.to(dev), backbone)

    # LoRA, merged at load (reference: load_adapter + enable_adapters,
    # reward_adaptor_loader.py:44-45)
    lora = None
    lora_dir = os.path.join(pm_path, "lora")
    if os.path.isdir(lora_dir):
        with open(os.path.join(lora_dir, "adapter_config.json")) as f:
            acfg = json.load(f)
        bin_path = os.path.join(lora_dir, "adapter_model.bin")
        lora_sd = load_torch_state_dict(
            bin_path if os.path.exists(bin_path)
            else os.path.join(lora_dir, "adapter_model.safetensors"))
        alpha, rank = float(acfg.get("lora_alpha", 1.0)), int(acfg.get("r", 1))
        targets = [t for t in default_targets if any(f"{t}.lora" in k for k in lora_sd)]
        lora = peft_state_to_stacked(lora_sd, decoder_cfg, alpha=alpha, rank=rank,
                                     targets=targets, dtype=dtype, device=dev)
        vision_merged = proj_merged = False
        if model_type == "phi3v":
            # unfrozen-vision adapters (reference CLIP targets,
            # utils/utils.py:205-213): merged into the CLIP tower / projector
            vlora = vision_peft_state_to_stacked(lora_sd, cfg.vision, alpha=alpha, rank=rank,
                                                 dtype=dtype, device=dev)
            if vlora:
                backbone["vision"]["clip"] = merge_vision_lora(backbone["vision"]["clip"], vlora)
                vision_merged = True
            proj_merged = _merge_projector_lora(backbone["vision"]["img_projection"], lora_sd,
                                                alpha, rank)
        _check_lora_consumed(lora_sd, targets, vision_merged, proj_merged, strict=strict)

    # in the full-checkpoint mode the base load above strict-checked every
    # key of the artifact's .bin, head keys excepted
    if not full_ckpt:
        check_artifact_keys(pm_path, strict=strict)
    head = load_head_params(pm_path, rcfg, dtype=dtype, device=dev)
    projector = None
    if ft_projector:
        load = {"phi3v": load_projector_params, "qwen": load_qwen_merger_params,
                "llava": load_llava_projector_params}[model_type]
        projector = load(pm_path, dtype=dtype, device=dev)
    # the decoder's LoRA merged, the projector in its slot, qwen's and llava's
    # projections fused (the JAX package fuses after quantizing; the scales are
    # per output column, so the codes are the same either way)
    backbone = merge_for_scoring(backbone, model_type, lora=lora, projector=projector)

    if quantize:
        scheme = {"w8a8": "w8a8", "nf4": "nf4"}.get(quantize, "absmax")
        bits = 4 if quantize in ("nf4", "int4") else 8
        dec = _SLOTS[model_type][1]
        backbone[dec] = {**backbone[dec], "layers": quantize_stacked_layers(
            backbone[dec]["layers"], bits=bits, scheme=scheme, min_size=quantize_min_size)}

    params = {"backbone": backbone, "head": head}
    if compute_dtype is not None:
        params = cast_params(params, compute_dtype)
    return RewardAdaptor(cfg=cfg, rcfg=rcfg, params=params, model_type=model_type, device=dev)
