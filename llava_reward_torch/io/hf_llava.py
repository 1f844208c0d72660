"""HF LlavaNext checkpoint -> the param tree (the port's own copy of
``llava_reward_tpu/io/hf_llava.py``).

Key layout (HF LlavaNextForConditionalGeneration; both the
'language_model.model.' and 'model.language_model.' generations are
accepted):
  vision_tower.vision_model.*            CLIP (the layout of phi3v's tower)
  multi_modal_projector.linear_{1,2}.{weight,bias}
  image_newline
  language_model.model.layers.{i}.self_attn.{q,k,v,o}_proj.weight
  language_model.model.layers.{i}.mlp.{gate,up,down}_proj.weight
  language_model.model.{embed_tokens.weight, norm.weight}
  language_model.lm_head.weight
"""

from __future__ import annotations

from typing import Dict

import torch

from ..core.config import LlavaNextConfig
from .torch_io import REWARD_HEAD_PATTERNS, TrackedStateDict, check_fully_consumed

_CLIP = "vision_tower.vision_model"
_CLIP_ATTN = (("q", "q_proj"), ("k", "k_proj"), ("v", "v_proj"), ("out", "out_proj"))
_ATTN, _MLP = ("q", "k", "v", "o"), ("gate", "up", "down")


def _t(x: torch.Tensor) -> torch.Tensor:
    return x.T.contiguous()


def _normalise_keys(sd: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    out = {}
    for k, v in sd.items():
        for pre in ("model.", ""):
            if k.startswith(pre + "language_model.model."):
                k = "lm." + k[len(pre + "language_model.model."):]
                break
            if k.startswith(pre + "language_model."):
                k = k[len(pre + "language_model."):]
                if not k.startswith("lm_head"):
                    k = "lm." + k
                break
        k = k.replace("model.vision_tower.", "vision_tower.")
        k = k.replace("model.multi_modal_projector.", "multi_modal_projector.")
        k = k.replace("model.image_newline", "image_newline")
        out[k] = v
    return out


def params_from_hf_state_dict(
    sd: Dict[str, torch.Tensor], cfg: LlavaNextConfig, dtype: torch.dtype = torch.float32,
    strict: bool = True, ignore_head_keys: bool = False,
) -> dict:
    """The llava param tree (models/llava_next.py layout) from an HF state
    dict, on the CPU in ``dtype``; strict as ``hf_phi3v``'s loader."""
    sd = TrackedStateDict(_normalise_keys(sd))
    tc, vc = cfg.text, cfg.vision

    def get(k):
        return sd[k].to(dtype)

    def tstack(fmt, transform=lambda x: x):
        return torch.stack([transform(get(fmt.format(i=i))) for i in range(tc.num_layers)])

    def clip_stacked(sub, transform=lambda x: x):
        return torch.stack([transform(get(f"{_CLIP}.encoder.layers.{i}.{sub}"))
                            for i in range(vc.num_layers)])

    def linear(sub):
        return {"kernel": clip_stacked(f"{sub}.weight", _t), "bias": clip_stacked(f"{sub}.bias")}

    def norm(sub):
        return {"weight": clip_stacked(f"{sub}.weight"), "bias": clip_stacked(f"{sub}.bias")}

    c = _CLIP
    patch = get(f"{c}.embeddings.patch_embedding.weight")  # (out, C, P, P)
    # CLIP's 'pre_layrnorm' (HF's typo, kept on disk); the fixed spelling too
    pre = f"{c}.pre_layrnorm" if f"{c}.pre_layrnorm.weight" in sd else f"{c}.pre_layernorm"
    clip = {
        "class_embedding": get(f"{c}.embeddings.class_embedding").reshape(-1),
        "patch_proj": patch.permute(2, 3, 1, 0).reshape(-1, patch.shape[0]).contiguous(),
        "position_embedding": get(f"{c}.embeddings.position_embedding.weight"),
        "pre_layernorm": {"weight": get(f"{pre}.weight"), "bias": get(f"{pre}.bias")},
        "layers": {
            "ln1": norm("layer_norm1"),
            "ln2": norm("layer_norm2"),
            "attn": {name: linear(f"self_attn.{proj}") for name, proj in _CLIP_ATTN},
            "mlp": {"fc1": linear("mlp.fc1"), "fc2": linear("mlp.fc2")},
        },
        "post_layernorm": {"weight": get(f"{c}.post_layernorm.weight"),
                           "bias": get(f"{c}.post_layernorm.bias")},
    }
    text = {
        "embed_tokens": get("lm.embed_tokens.weight"),
        "layers": {
            "input_layernorm": tstack("lm.layers.{i}.input_layernorm.weight"),
            **{f"{n}_proj": {"kernel": tstack(f"lm.layers.{{i}}.self_attn.{n}_proj.weight", _t)}
               for n in _ATTN},
            "post_attention_layernorm": tstack("lm.layers.{i}.post_attention_layernorm.weight"),
            **{f"{n}_proj": {"kernel": tstack(f"lm.layers.{{i}}.mlp.{n}_proj.weight", _t)}
               for n in _MLP},
        },
        "final_layernorm": get("lm.norm.weight"),
    }
    p = "multi_modal_projector"
    tree = {
        "vision": {
            "clip": clip,
            "projector": {fc: {"kernel": _t(get(f"{p}.linear_{i}.weight")),
                               "bias": get(f"{p}.linear_{i}.bias")}
                          for fc, i in (("fc1", 1), ("fc2", 2))},
            "image_newline": get("image_newline").reshape(-1),
        },
        "text": text,
    }
    if "lm_head.weight" in sd:
        tree["lm_head"] = _t(get("lm_head.weight"))
    check_fully_consumed(
        sd, strict=strict, what="llava base checkpoint",
        ignore=REWARD_HEAD_PATTERNS if ignore_head_keys else (),
    )
    return tree

