"""LoRA adapters as stacked param trees, and PEFT checkpoint interop
(``llava_reward_tpu/lora/lora.py``).

The tree is the JAX package's exactly: per target
``{'a': (L, in, r), 'b': (L, r, out), 'scale': (L,)}`` with ``scale =
alpha / r``, applied inline as ``x @ a @ b * scale`` (``models/phi3.py``,
``models/clip_vit.py``). ``scale`` is a leaf of the trainable tree, so the
gradient reaches it and AdamW updates it, as in the JAX package (upstream
PEFT keeps the scaling constant).

PEFT on-disk keys (``lora/adapter_model.bin``):
  base_model.model.model.layers.{i}.self_attn.qkv_proj.lora_A.weight (r, in)
  base_model.model.model.layers.{i}.self_attn.qkv_proj.lora_B.weight (out, r)
  (mlp.gate_up_proj / mlp.down_proj / self_attn.o_proj likewise, and
  Qwen2.5-VL's separate q/k/v_proj, gate_proj, up_proj; the CLIP
  tower's under vision_embed_tokens.img_processor.vision_model.encoder).
"""

from __future__ import annotations

import math
from typing import Dict, Sequence

import torch

from ..core.device import DEFAULT_DEVICE, resolve_device

DEFAULT_TARGETS = ("qkv_proj", "o_proj", "gate_up_proj", "down_proj")
# Qwen2.5-VL keeps q/k/v and gate/up separate under LoRA (``lora.py:34-36``)
QWEN_TARGETS = ("q_proj", "k_proj", "v_proj", "o_proj", "gate_proj", "up_proj", "down_proj")
CLIP_TARGETS = ("q", "k", "v", "out", "fc1", "fc2")

_PEFT_PATH = {
    "qkv_proj": "self_attn.qkv_proj",
    "o_proj": "self_attn.o_proj",
    "gate_up_proj": "mlp.gate_up_proj",
    "down_proj": "mlp.down_proj",
    "q_proj": "self_attn.q_proj",
    "k_proj": "self_attn.k_proj",
    "v_proj": "self_attn.v_proj",
    "gate_proj": "mlp.gate_proj",
    "up_proj": "mlp.up_proj",
}
_VISION_PEFT_PATH = {
    "q": "self_attn.q_proj",
    "k": "self_attn.k_proj",
    "v": "self_attn.v_proj",
    "out": "self_attn.out_proj",
    "fc1": "mlp.fc1",
    "fc2": "mlp.fc2",
}
_VISION_PEFT_PREFIX = "vision_embed_tokens.img_processor.vision_model.encoder.layers"


def _target_dims(cfg, name: str):
    H, I = cfg.hidden_size, cfg.intermediate_size
    return {
        "qkv_proj": (H, cfg.q_size + 2 * cfg.kv_size),
        "o_proj": (cfg.q_size, H),
        "gate_up_proj": (H, 2 * I),
        "down_proj": (I, H),
        "q_proj": (H, cfg.q_size),
        "k_proj": (H, cfg.kv_size),
        "v_proj": (H, cfg.kv_size),
        "gate_proj": (H, I),
        "up_proj": (H, I),
    }[name]


def _vision_dims(vcfg, name: str):
    H, I = vcfg.hidden_size, vcfg.intermediate_size
    return {"q": (H, H), "k": (H, H), "v": (H, H), "out": (H, H),
            "fc1": (H, I), "fc2": (I, H)}[name]


def _init(dims, L, rank, alpha, targets, generator, dtype, device) -> dict:
    """A ~ kaiming-uniform(a=sqrt(5)) over (r, in) like PEFT, drawn per
    target in order from ``generator``; B = 0."""
    dev = resolve_device(device)
    tree = {}
    for name in targets:
        in_dim, out_dim = dims(name)
        bound = math.sqrt(6.0 / in_dim)
        u = torch.rand(L, in_dim, rank, generator=generator, device=dev, dtype=torch.float32)
        tree[name] = {
            "a": (u * (2 * bound) - bound).to(dtype),
            "b": torch.zeros(L, rank, out_dim, dtype=dtype, device=dev),
            "scale": torch.full((L,), alpha / rank, dtype=dtype, device=dev),
        }
    return tree


def init_lora(cfg, rank: int, alpha: float, generator: torch.Generator,
              targets: Sequence[str] = DEFAULT_TARGETS, dtype=torch.float32,
              device=DEFAULT_DEVICE) -> dict:
    """Decoder LoRA (``lora.py:68-89``) for a ``DecoderConfig`` or a
    ``QwenTextConfig`` (``targets=QWEN_TARGETS``)."""
    return _init(lambda n: _target_dims(cfg, n), cfg.num_layers, rank, alpha, targets,
                 generator, dtype, device)


def init_vision_lora(vcfg, rank: int, alpha: float, generator: torch.Generator,
                     targets: Sequence[str] = CLIP_TARGETS, dtype=torch.float32,
                     device=DEFAULT_DEVICE) -> dict:
    """CLIP LoRA (``lora.py:95-123``, ``--train_vision``) over all
    ``num_layers`` layers; only the active ones run."""
    return _init(lambda n: _vision_dims(vcfg, n), vcfg.num_layers, rank, alpha, targets,
                 generator, dtype, device)


def _delta(t: dict) -> torch.Tensor:
    return torch.einsum("lir,lro->lio", t["a"], t["b"]) * t["scale"][:, None, None]


def merge_lora(base_layers: dict, lora: dict) -> dict:
    """Fold adapters into the frozen stacked weights (``lora.py:126-140``):
    bare stacked matrices (phi3's fused projections) and ``{'kernel', 'bias'}``
    leaves (the Qwen layers) alike."""
    merged = dict(base_layers)
    for name, t in lora.items():
        base = base_layers[name]
        if isinstance(base, dict):
            merged[name] = {**base, "kernel": base["kernel"] + _delta(t).to(base["kernel"].dtype)}
        else:
            merged[name] = base + _delta(t).to(base.dtype)
    return merged


def merge_vision_lora(clip_params: dict, vlora: dict) -> dict:
    """Fold stacked CLIP LoRA into the clip tree (``lora.py:277-292``):
    ``layers.attn.{q,k,v,out}.kernel``, ``layers.mlp.{fc1,fc2}.kernel``."""
    lay = clip_params["layers"]
    new_lay = {**lay, "attn": dict(lay["attn"]), "mlp": dict(lay["mlp"])}
    for name, t in vlora.items():
        group = "attn" if name in ("q", "k", "v", "out") else "mlp"
        sub = lay[group][name]
        new_lay[group][name] = {**sub, "kernel": sub["kernel"] + _delta(t).to(sub["kernel"].dtype)}
    return {**clip_params, "layers": new_lay}


def _host(t: torch.Tensor) -> torch.Tensor:
    return t.detach().cpu()


def stacked_to_peft_state(lora: dict, cfg) -> Dict[str, torch.Tensor]:
    """Stacked tree -> PEFT adapter_model dict on the CPU (``lora.py:183-197``)."""
    sd: Dict[str, torch.Tensor] = {}
    for name, t in lora.items():
        a, b = _host(t["a"]), _host(t["b"])
        for i in range(cfg.num_layers):
            prefix = f"base_model.model.model.layers.{i}.{_PEFT_PATH[name]}"
            sd[f"{prefix}.lora_A.weight"] = a[i].T.contiguous()
            sd[f"{prefix}.lora_B.weight"] = b[i].T.contiguous()
    return sd


def vision_stacked_to_peft_state(vlora: dict, vcfg) -> Dict[str, torch.Tensor]:
    """Stacked CLIP tree -> PEFT keys (``lora.py:216-228``)."""
    sd: Dict[str, torch.Tensor] = {}
    for name, t in vlora.items():
        a, b = _host(t["a"]), _host(t["b"])
        for i in range(a.shape[0]):
            prefix = f"base_model.model.model.{_VISION_PEFT_PREFIX}.{i}.{_VISION_PEFT_PATH[name]}"
            sd[f"{prefix}.lora_A.weight"] = a[i].T.contiguous()
            sd[f"{prefix}.lora_B.weight"] = b[i].T.contiguous()
    return sd


def _finder(sd, what: str):
    def find(stem: str, ab: str):
        suffixes = (f"{stem}.lora_{ab}.weight", f"{stem}.lora_{ab}.default.weight")
        for k, v in sd.items():
            if k.endswith(suffixes):
                return _host(v)
        raise KeyError(f"missing {what} lora weight {stem} {ab}")

    return find


def _stack(find, stems, alpha, rank, dtype, device) -> dict:
    dev = resolve_device(device)
    a = torch.stack([find(s, "A").to(dtype).T for s in stems]).contiguous().to(dev)
    b = torch.stack([find(s, "B").to(dtype).T for s in stems]).contiguous().to(dev)
    return {"a": a, "b": b,
            "scale": torch.full((len(stems),), alpha / rank, dtype=dtype, device=dev)}


def peft_state_to_stacked(sd: dict, cfg, alpha: float, rank: int,
                          targets: Sequence[str] = DEFAULT_TARGETS, dtype=torch.float32,
                          device=DEFAULT_DEVICE) -> dict:
    """PEFT adapter_model dict of tensors -> stacked tree
    (``lora.py:143-180``); ``base_model.model.model.layers`` and
    ``model.layers`` prefixes, optional ``.default.`` segments."""
    find = _finder(sd, "decoder")
    return {
        name: _stack(find, [f"model.layers.{i}.{_PEFT_PATH[name]}" for i in range(cfg.num_layers)],
                     alpha, rank, dtype, device)
        for name in targets
    }


def vision_peft_state_to_stacked(sd: dict, vcfg, alpha: float, rank: int,
                                 dtype=torch.float32, device=DEFAULT_DEVICE) -> dict:
    """PEFT keys on the CLIP tower -> stacked tree (``lora.py:231-274``); {}
    when the adapter has none."""
    find = _finder(sd, "vision")
    tree = {}
    for name, path in _VISION_PEFT_PATH.items():
        if any(_VISION_PEFT_PREFIX in k and f"{path}.lora_A" in k for k in sd):
            stems = [f"{_VISION_PEFT_PREFIX}.{i}.{path}" for i in range(vcfg.num_layers)]
            tree[name] = _stack(find, stems, alpha, rank, dtype, device)
    return tree


def peft_adapter_config(rank: int, alpha: float, dropout: float,
                        targets: Sequence[str] = DEFAULT_TARGETS) -> dict:
    """adapter_config.json (``lora.py:295-308``)."""
    return {
        "peft_type": "LORA",
        "task_type": "CAUSAL_LM",
        "r": int(rank),
        "lora_alpha": float(alpha),
        "lora_dropout": float(dropout),
        "bias": "none",
        "target_modules": list(targets),
        "base_model_name_or_path": None,
    }
