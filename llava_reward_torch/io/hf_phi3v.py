"""HF Phi-3.5-vision checkpoint <-> the param tree (the port's own copy of
``llava_reward_tpu/io/hf_phi3v.py``).

Key mapping (microsoft/Phi-3.5-vision-instruct's state dict, which the
reference's vendored Phi3VForCausalLM produces and consumes,
modeling_phi3_v.py:1332-1742):

  model.embed_tokens.weight                         -> decoder.embed_tokens
  model.layers.{i}.input_layernorm.weight           -> stacked layers
  model.layers.{i}.self_attn.qkv_proj.weight        (fused, kept fused)
  model.layers.{i}.self_attn.o_proj.weight
  model.layers.{i}.post_attention_layernorm.weight
  model.layers.{i}.mlp.gate_up_proj.weight          (fused, kept fused)
  model.layers.{i}.mlp.down_proj.weight
  model.norm.weight                                 -> decoder.final_layernorm
  lm_head.weight                                    -> lm_head (optional)
  model.vision_embed_tokens.{glb_GN,sub_GN}
  model.vision_embed_tokens.img_projection.{0,2}.{weight,bias}
  model.vision_embed_tokens.img_processor.vision_model.*   (CLIP tower;
      HF's 'pre_layrnorm' typo is kept on disk)

torch Linear weights are (out, in); the tree's kernels are (in, out), so
they are transposed at load and save. The CLIP patch conv (out, C, P, P)
maps to the tree's (P*P*C, out) ``patch_proj`` with flat order (ph, pw, C),
the reshape-based patchify's (models/clip_vit.py). The tree is the port's
dense layout on the CPU; ``utils/quantize`` makes W8A8 leaves (K-major) from
it afterwards.
"""

from __future__ import annotations

from typing import Dict

import torch

from ..core.config import Phi3VConfig
from .torch_io import REWARD_HEAD_PATTERNS, TrackedStateDict, check_fully_consumed

_CLIP_PREFIX = "model.vision_embed_tokens.img_processor.vision_model"
_CLIP_ATTN = (("q", "q_proj"), ("k", "k_proj"), ("v", "v_proj"), ("out", "out_proj"))


def _t(x: torch.Tensor) -> torch.Tensor:
    return x.T.contiguous()


def params_from_hf_state_dict(
    sd: Dict[str, torch.Tensor], cfg: Phi3VConfig, dtype: torch.dtype = torch.float32,
    strict: bool = True, ignore_head_keys: bool = False,
) -> dict:
    """The phi3v param tree (models/phi3v.py layout) from an HF state dict,
    on the CPU in ``dtype``. A missing weight raises KeyError with context;
    keys the mapping never reads raise ValueError unless ``strict=False``
    (then a warning), as strict load_state_dict does
    (eval/reward_adaptor_loader.py:46-63).

    ``ignore_head_keys``: set only in the full-checkpoint mode, where the
    artifact's .bin holds reward-head keys next to the backbone's; a separate
    base checkpoint keeps the strict check whole, so stale head keys are
    flagged."""
    sd = TrackedStateDict(sd)
    L = cfg.decoder.num_layers
    VL = cfg.vision.num_layers

    def get(k):
        return sd[k].to(dtype)

    def stack(fmt, transform=lambda x: x, n=L):
        return torch.stack([transform(get(fmt.format(i=i))) for i in range(n)])

    decoder = {
        "embed_tokens": get("model.embed_tokens.weight"),
        "layers": {
            "input_layernorm": stack("model.layers.{i}.input_layernorm.weight"),
            "qkv_proj": stack("model.layers.{i}.self_attn.qkv_proj.weight", _t),
            "o_proj": stack("model.layers.{i}.self_attn.o_proj.weight", _t),
            "post_attention_layernorm": stack("model.layers.{i}.post_attention_layernorm.weight"),
            "gate_up_proj": stack("model.layers.{i}.mlp.gate_up_proj.weight", _t),
            "down_proj": stack("model.layers.{i}.mlp.down_proj.weight", _t),
        },
        "final_layernorm": get("model.norm.weight"),
    }

    c = _CLIP_PREFIX
    patch = get(f"{c}.embeddings.patch_embedding.weight")  # (out, C, P, P)
    # -> (P, P, C, out) -> (P*P*C, out)
    patch_proj = patch.permute(2, 3, 1, 0).reshape(-1, patch.shape[0]).contiguous()

    def clip_stacked(sub, transform=lambda x: x):
        return torch.stack([transform(get(f"{c}.encoder.layers.{i}.{sub}")) for i in range(VL)])

    def linear(sub):
        return {"kernel": clip_stacked(f"{sub}.weight", _t), "bias": clip_stacked(f"{sub}.bias")}

    def norm(sub):
        return {"weight": clip_stacked(f"{sub}.weight"), "bias": clip_stacked(f"{sub}.bias")}

    clip = {
        "class_embedding": get(f"{c}.embeddings.class_embedding").reshape(-1),
        "patch_proj": patch_proj,
        "position_embedding": get(f"{c}.embeddings.position_embedding.weight"),
        "pre_layernorm": {"weight": get(f"{c}.pre_layrnorm.weight"),
                          "bias": get(f"{c}.pre_layrnorm.bias")},
        "layers": {
            "ln1": norm("layer_norm1"),
            "ln2": norm("layer_norm2"),
            "attn": {name: linear(f"self_attn.{proj}") for name, proj in _CLIP_ATTN},
            "mlp": {"fc1": linear("mlp.fc1"), "fc2": linear("mlp.fc2")},
        },
        "post_layernorm": {"weight": get(f"{c}.post_layernorm.weight"),
                           "bias": get(f"{c}.post_layernorm.bias")},
    }

    p = "model.vision_embed_tokens.img_projection"
    vision = {
        "clip": clip,
        "glb_GN": get("model.vision_embed_tokens.glb_GN").reshape(-1),
        "sub_GN": get("model.vision_embed_tokens.sub_GN").reshape(-1),
        "img_projection": {
            fc: {"kernel": _t(get(f"{p}.{i}.weight")), "bias": get(f"{p}.{i}.bias")}
            for fc, i in (("fc1", 0), ("fc2", 2))
        },
    }

    tree = {"decoder": decoder, "vision": vision}
    if "lm_head.weight" in sd:
        tree["lm_head"] = _t(get("lm_head.weight"))
    # vision_embed_tokens.wte IS model.embed_tokens (the image embedder holds
    # the shared text embedding module, modeling_phi3_v.py:1355); checkpoints
    # serialise it as a duplicate key, consumed through embed_tokens
    check_fully_consumed(
        sd, strict=strict, what="phi3v base checkpoint",
        ignore=(r"^model\.vision_embed_tokens\.wte\.weight$",)
        + (REWARD_HEAD_PATTERNS if ignore_head_keys else ()),
    )
    return tree


def hf_state_dict_from_params(params: dict, cfg: Phi3VConfig) -> Dict[str, torch.Tensor]:
    """The inverse mapping, for full exports (deepspeed.py:277): CPU tensors
    in the tree's dtype."""

    def h(x):  # a copy: a slice of a stacked leaf would save the whole stack
        return x.detach().to("cpu", copy=True)

    def ht(x):
        return h(x).T.contiguous()

    sd: Dict[str, torch.Tensor] = {}
    dec = params["decoder"]
    sd["model.embed_tokens.weight"] = h(dec["embed_tokens"])
    lay = dec["layers"]
    for i in range(cfg.decoder.num_layers):
        pre = f"model.layers.{i}"
        sd[f"{pre}.input_layernorm.weight"] = h(lay["input_layernorm"][i])
        sd[f"{pre}.self_attn.qkv_proj.weight"] = ht(lay["qkv_proj"][i])
        sd[f"{pre}.self_attn.o_proj.weight"] = ht(lay["o_proj"][i])
        sd[f"{pre}.post_attention_layernorm.weight"] = h(lay["post_attention_layernorm"][i])
        sd[f"{pre}.mlp.gate_up_proj.weight"] = ht(lay["gate_up_proj"][i])
        sd[f"{pre}.mlp.down_proj.weight"] = ht(lay["down_proj"][i])
    sd["model.norm.weight"] = h(dec["final_layernorm"])
    if "lm_head" in params:
        sd["lm_head.weight"] = ht(params["lm_head"])

    vis = params["vision"]
    sd["model.vision_embed_tokens.glb_GN"] = h(vis["glb_GN"]).reshape(1, 1, -1)
    sd["model.vision_embed_tokens.sub_GN"] = h(vis["sub_GN"]).reshape(1, 1, 1, -1)
    p = "model.vision_embed_tokens.img_projection"
    for fc, i in (("fc1", 0), ("fc2", 2)):
        sd[f"{p}.{i}.weight"] = ht(vis["img_projection"][fc]["kernel"])
        sd[f"{p}.{i}.bias"] = h(vis["img_projection"][fc]["bias"])

    c = _CLIP_PREFIX
    clip = vis["clip"]
    P, C, H = cfg.vision.patch_size, cfg.vision.num_channels, cfg.vision.hidden_size
    sd[f"{c}.embeddings.class_embedding"] = h(clip["class_embedding"])
    sd[f"{c}.embeddings.patch_embedding.weight"] = (
        h(clip["patch_proj"]).reshape(P, P, C, H).permute(3, 2, 0, 1).contiguous())
    sd[f"{c}.embeddings.position_embedding.weight"] = h(clip["position_embedding"])
    sd[f"{c}.pre_layrnorm.weight"] = h(clip["pre_layernorm"]["weight"])
    sd[f"{c}.pre_layrnorm.bias"] = h(clip["pre_layernorm"]["bias"])
    cl = clip["layers"]
    for i in range(cfg.vision.num_layers):
        pre = f"{c}.encoder.layers.{i}"
        for ln, key in (("ln1", "layer_norm1"), ("ln2", "layer_norm2")):
            sd[f"{pre}.{key}.weight"] = h(cl[ln]["weight"][i])
            sd[f"{pre}.{key}.bias"] = h(cl[ln]["bias"][i])
        for name, proj in _CLIP_ATTN:
            sd[f"{pre}.self_attn.{proj}.weight"] = ht(cl["attn"][name]["kernel"][i])
            sd[f"{pre}.self_attn.{proj}.bias"] = h(cl["attn"][name]["bias"][i])
        for fc in ("fc1", "fc2"):
            sd[f"{pre}.mlp.{fc}.weight"] = ht(cl["mlp"][fc]["kernel"][i])
            sd[f"{pre}.mlp.{fc}.bias"] = h(cl["mlp"][fc]["bias"][i])
    sd[f"{c}.post_layernorm.weight"] = h(clip["post_layernorm"]["weight"])
    sd[f"{c}.post_layernorm.bias"] = h(clip["post_layernorm"]["bias"])
    return sd
