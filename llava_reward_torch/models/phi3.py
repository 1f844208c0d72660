"""Phi-3 decoder (``llava_reward_tpu/models/phi3.py``).

Layer: h -> RMSNorm -> fused qkv -> su-RoPE causal attention -> o_proj
-> +residual -> RMSNorm -> fused gate_up, silu-gated -> down -> +residual,
with a final RMSNorm. Layers are stacked on a leading axis and run by a
Python loop (``lax.scan`` in JAX).

Projection leaves may be quantized (``utils/quantize.py``): weight-only
leaves are dequantized per layer, W8A8 leaves run through the int8 GEMM.
With W8A8 leaves, no LoRA and a 128-multiple width, the kernel route
(on the card, or ``attn_impl="pallas"``) takes the activation codes straight
from the quantizing epilogues (``ops/quant_epilogue.py``): RMSNorm ->
codes for qkv and gate_up, attention output -> codes for o_proj,
silu(gate)*up -> codes for down (``phi3.py:103-166``).

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
from ..core.device import DEFAULT_DEVICE, on_card, resolve_device
from ..ops import quant_epilogue as qe
from ..ops.activations import ACT2FN
from ..ops.attention import fused_rope_attention
from ..ops.norms import rms_norm
from ..ops.rope import rope_cos_sin_for_config
from ..utils.quantize import dequant_layer, int8_linear_pre, is_w8a8, qmatmul
from .clip_vit import layer_slice


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
    lp = dequant_layer(lp, h.dtype)
    eps = cfg.rms_norm_eps
    # attn_impl="plain" sends the epilogues and the int8 GEMM to their plain
    # versions too; "pallas" forces their route on any device
    plain = attn_impl == "plain"
    use_rq = lora_layer is None and (attn_impl == "pallas" or on_card(h)) and qe.supported(h)
    rms_q = qe.rms_quant_plain if plain else qe.rms_quant

    residual = h
    if use_rq and is_w8a8(lp["qkv_proj"]):
        codes, rs = rms_q(h, lp["input_layernorm"], eps)
        qkv = int8_linear_pre(codes, rs, lp["qkv_proj"], h.dtype, plain)
    else:
        x = rms_norm(h, lp["input_layernorm"], eps)
        qkv = _maybe_lora(x, qmatmul(x, lp["qkv_proj"], plain), lora_layer, "qkv_proj")
    attn = fused_rope_attention(
        qkv, cos, sin,
        n_heads=cfg.num_heads, n_kv_heads=cfg.num_kv_heads, head_dim=cfg.head_dim,
        causal=True, key_padding_mask=attention_mask,
        sliding_window=cfg.sliding_window, impl=attn_impl,
    )
    if use_rq and is_w8a8(lp["o_proj"]):
        codes, rs = (qe.row_quant_plain if plain else qe.row_quant)(attn)
        attn = int8_linear_pre(codes, rs, lp["o_proj"], h.dtype, plain)
    else:
        attn = _maybe_lora(attn, qmatmul(attn, lp["o_proj"], plain), lora_layer, "o_proj")
    h = residual + attn

    residual = h
    if use_rq and is_w8a8(lp["gate_up_proj"]):
        codes, rs = rms_q(h, lp["post_attention_layernorm"], eps)
        gate_up = int8_linear_pre(codes, rs, lp["gate_up_proj"], h.dtype, plain)
    else:
        x = rms_norm(h, lp["post_attention_layernorm"], eps)
        gate_up = _maybe_lora(x, qmatmul(x, lp["gate_up_proj"], plain), lora_layer,
                              "gate_up_proj")
    if (
        use_rq
        and is_w8a8(lp["down_proj"])
        and cfg.hidden_act == "silu"
        and cfg.intermediate_size % 128 == 0
    ):
        codes, rs = (qe.silu_mul_quant_plain if plain else qe.silu_mul_quant)(gate_up)
        mlp = int8_linear_pre(codes, rs, lp["down_proj"], h.dtype, plain)
    else:
        gate, up = torch.chunk(gate_up, 2, dim=-1)
        mlp = up * ACT2FN[cfg.hidden_act](gate)
        mlp = _maybe_lora(mlp, qmatmul(mlp, lp["down_proj"], plain), lora_layer, "down_proj")
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
        lora_layer = layer_slice(lora, i) if lora is not None else None
        h = decoder_layer(h, layer_slice(layers, i), cfg, cos, sin, attention_mask, attn_impl,
                          lora_layer)
        if collect and i + 1 == collect_layer_id:
            collected = h

    last = rms_norm(h, params["final_layernorm"], cfg.rms_norm_eps)
    return DecoderOutput(last_hidden_state=last, collected_hidden_state=collected)
