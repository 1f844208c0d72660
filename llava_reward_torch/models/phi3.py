"""Phi-3 decoder (``llava_reward_tpu/models/phi3.py``), bf16 path.

Layer: h -> RMSNorm -> fused qkv -> su-RoPE causal attention -> o_proj
-> +residual -> RMSNorm -> fused gate_up, silu-gated -> down -> +residual,
with a final RMSNorm. Layers are stacked on a leading axis and run by a
Python loop (``lax.scan`` in JAX). The W8A8 branches of the JAX layer wait
for ROADMAP slice 2.

Param tree:
  {'embed_tokens': (V, H),
   'layers': {'input_layernorm': (L, H), 'qkv_proj': (L, H, q+2kv),
              'o_proj': (L, H, H), 'post_attention_layernorm': (L, H),
              'gate_up_proj': (L, H, 2I), 'down_proj': (L, I, H)},
   'final_layernorm': (H,)}
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..core.config import DecoderConfig
from ..core.device import DEFAULT_DEVICE, resolve_device
from ..ops.activations import ACT2FN
from ..ops.attention import fused_rope_attention
from ..ops.norms import rms_norm
from ..ops.rope import rope_cos_sin_for_config


def init_params(
    cfg: DecoderConfig,
    generator: torch.Generator,
    dtype: torch.dtype = torch.float32,
    device=DEFAULT_DEVICE,
) -> dict:
    """Random init (normal, std 0.02) drawn from ``generator`` on ``device``."""
    dev = resolve_device(device)
    H, I, L, V = cfg.hidden_size, cfg.intermediate_size, cfg.num_layers, cfg.vocab_size

    def dense(*shape):
        return torch.randn(*shape, generator=generator, device=dev, dtype=dtype).mul_(0.02)

    return {
        "embed_tokens": dense(V, H),
        "layers": {
            "input_layernorm": torch.ones(L, H, device=dev, dtype=dtype),
            "qkv_proj": dense(L, H, cfg.q_size + 2 * cfg.kv_size),
            "o_proj": dense(L, cfg.q_size, H),
            "post_attention_layernorm": torch.ones(L, H, device=dev, dtype=dtype),
            "gate_up_proj": dense(L, H, 2 * I),
            "down_proj": dense(L, I, H),
        },
        "final_layernorm": torch.ones(H, device=dev, dtype=dtype),
    }


def _maybe_lora(x, base_out, lora_layer, name):
    """LoRA hook of ``phi3.py:71-80``; a no-op while ``lora is None``."""
    if lora_layer is None or name not in lora_layer:
        return base_out
    t = lora_layer[name]
    return base_out + (x @ t["a"].to(x.dtype)) @ t["b"].to(x.dtype) * t["scale"].to(x.dtype)


def decoder_layer(
    h: torch.Tensor,  # (B, S, H)
    lp: dict,  # per-layer params
    cfg: DecoderConfig,
    cos: torch.Tensor,
    sin: torch.Tensor,
    attention_mask: Optional[torch.Tensor],  # (B, S) 1=valid
    attn_impl: str,
    lora_layer: Optional[dict] = None,
) -> torch.Tensor:
    residual = h
    x = rms_norm(h, lp["input_layernorm"], cfg.rms_norm_eps)
    qkv = _maybe_lora(x, x @ lp["qkv_proj"], lora_layer, "qkv_proj")
    attn = fused_rope_attention(
        qkv, cos, sin,
        n_heads=cfg.num_heads, n_kv_heads=cfg.num_kv_heads, head_dim=cfg.head_dim,
        causal=True, key_padding_mask=attention_mask,
        sliding_window=cfg.sliding_window, impl=attn_impl,
    )
    attn = _maybe_lora(attn, attn @ lp["o_proj"], lora_layer, "o_proj")
    h = residual + attn

    residual = h
    x = rms_norm(h, lp["post_attention_layernorm"], cfg.rms_norm_eps)
    gate_up = _maybe_lora(x, x @ lp["gate_up_proj"], lora_layer, "gate_up_proj")
    gate, up = torch.chunk(gate_up, 2, dim=-1)
    mlp = up * ACT2FN[cfg.hidden_act](gate)
    mlp = _maybe_lora(mlp, mlp @ lp["down_proj"], lora_layer, "down_proj")
    return residual + mlp


class DecoderOutput(NamedTuple):
    last_hidden_state: torch.Tensor  # post-final-RMSNorm (B, S, H)
    collected_hidden_state: Optional[torch.Tensor]  # pre-norm layer output, or None


def forward(
    params: dict,
    cfg: DecoderConfig,
    inputs_embeds: torch.Tensor,  # (B, S, H)
    attention_mask: Optional[torch.Tensor],
    position_ids: torch.Tensor,  # (B, S)
    *,
    collect_layer_id: Optional[int] = None,
    attn_impl: str = "auto",
    lora: Optional[dict] = None,
) -> DecoderOutput:
    """``collect_layer_id`` uses HF hidden_states indexing (0 = embeddings,
    i = output of layer i, pre-final-norm); ``num_layers`` or None means the
    post-norm last_hidden_state only (``phi3.py:180-225``)."""
    cos, sin = rope_cos_sin_for_config(position_ids, cfg, dtype=inputs_embeds.dtype)
    collect = collect_layer_id is not None and collect_layer_id < cfg.num_layers
    collected = inputs_embeds if collect else None  # collect_layer_id == 0

    h = inputs_embeds
    layers = params["layers"]
    for i in range(cfg.num_layers):
        lp = {k: v[i] for k, v in layers.items()}
        lora_layer = (
            {n: {k: v[i] for k, v in t.items()} for n, t in lora.items()}
            if lora is not None else None
        )
        h = decoder_layer(h, lp, cfg, cos, sin, attention_mask, attn_impl, lora_layer)
        if collect and i + 1 == collect_layer_id:
            collected = h

    last = rms_norm(h, params["final_layernorm"], cfg.rms_norm_eps)
    return DecoderOutput(last_hidden_state=last, collected_hidden_state=collected)
