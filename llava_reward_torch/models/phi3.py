"""Phi-3 decoder (``llava_reward_tpu/models/phi3.py``).

Layer: h -> RMSNorm -> fused qkv -> su-RoPE causal attention -> o_proj
-> +residual -> RMSNorm -> fused gate_up, silu-gated -> down -> +residual,
with a final RMSNorm. Layers are stacked on a leading axis and run by a
Python loop (``lax.scan`` in JAX). With ``remat`` each layer runs under
``torch.utils.checkpoint`` (non-reentrant): only its inputs are kept and
the layer is recomputed in the backward, as ``jax.checkpoint`` with
``nothing_saveable`` does (``phi3.py:199-203``).

Projection leaves may be quantized (``utils/quantize.py``): weight-only
leaves are dequantized per layer, W8A8 leaves run through the int8 GEMM.
With W8A8 leaves, no LoRA and a 128-multiple width, the kernel route
(on the card, or ``attn_impl="pallas"``) takes the activation codes straight
from the quantizing epilogues (``ops/quant_epilogue.py``): RMSNorm ->
codes for qkv and gate_up, attention output -> codes for o_proj,
silu(gate)*up -> codes for down (``phi3.py:103-166``). Under tp the
RMSNorm codes are the whole row's, the same on every rank, into the rank's
qkv / gate_up columns; o_proj's and down's codes are taken on the tp-global
row amax (``parallel/tensor.row`` / ``row_silu_mul``).

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
from ..ops.linear import mm
from ..ops.norms import rms_norm
from ..ops.rope import rope_cos_sin_for_config
from ..parallel.tensor import (column, enter, local_cols, local_heads, lora_of, row,
                               row_silu_mul)
from ..utils.quantize import dequant_layer, int8_linear_pre, is_w8a8
from .clip_vit import stacked_layer


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


def decoder_layer(
    h: torch.Tensor,  # (B, S, H)
    lp: dict,  # per-layer params
    cfg: DecoderConfig,
    cos: torch.Tensor,
    sin: torch.Tensor,
    attention_mask: Optional[torch.Tensor],  # (B, S) 1=valid
    attn_impl: str,
    lora_layer: Optional[dict] = None,
    tp=None,
) -> torch.Tensor:
    """One layer; under ``tp`` (``parallel/tensor.TensorParallel``) this
    rank's heads and MLP columns: qkv and gate_up column-split, o and down
    row-split."""
    lp = dequant_layer(lp, h.dtype)
    eps = cfg.rms_norm_eps
    # attn_impl="plain" sends the epilogues and the int8 GEMM to their plain
    # versions too; "pallas" forces their route on any device
    plain = attn_impl == "plain"
    use_rq = lora_layer is None and (attn_impl == "pallas" or on_card(h)) and qe.supported(h)
    rms_q = qe.rms_quant_plain if plain else qe.rms_quant
    nh, nkv = local_heads(cfg.num_heads, tp), local_heads(cfg.num_kv_heads, tp)
    qkv_parts, gate_up_parts = (cfg.q_size, cfg.kv_size, cfg.kv_size), (cfg.intermediate_size,) * 2

    residual = h
    if use_rq and is_w8a8(lp["qkv_proj"]):
        codes, rs = rms_q(h, lp["input_layernorm"], eps)
        qkv = int8_linear_pre(codes, rs, local_cols(lp["qkv_proj"], tp, qkv_parts), h.dtype,
                              plain)
    else:
        x = enter(rms_norm(h, lp["input_layernorm"], eps), tp)
        qkv = column(x, lp["qkv_proj"], lora=lora_of(lora_layer, "qkv_proj"), tp=tp,
                     parts=qkv_parts, plain=plain)
    attn = fused_rope_attention(
        qkv, cos, sin,
        n_heads=nh, n_kv_heads=nkv, head_dim=cfg.head_dim,
        causal=True, key_padding_mask=attention_mask,
        sliding_window=cfg.sliding_window, impl=attn_impl,
    )
    # a W8A8 o_proj quantizes its input by rows (B6, on the tp-global amax
    # under tp) into the GEMM, on every route
    attn = row(attn, lp["o_proj"], lora=lora_of(lora_layer, "o_proj"), tp=tp, plain=plain)
    h = residual + attn

    residual = h
    if use_rq and is_w8a8(lp["gate_up_proj"]):
        codes, rs = rms_q(h, lp["post_attention_layernorm"], eps)
        gate_up = int8_linear_pre(codes, rs, local_cols(lp["gate_up_proj"], tp, gate_up_parts),
                                  h.dtype, plain)
    else:
        x = enter(rms_norm(h, lp["post_attention_layernorm"], eps), tp)
        gate_up = column(x, lp["gate_up_proj"], lora=lora_of(lora_layer, "gate_up_proj"),
                         tp=tp, parts=gate_up_parts, plain=plain)
    if (
        use_rq
        and is_w8a8(lp["down_proj"])
        and cfg.hidden_act == "silu"
        and local_heads(cfg.intermediate_size, tp) % 128 == 0
    ):
        mlp = row_silu_mul(gate_up, lp["down_proj"], tp=tp, plain=plain)
    else:
        gate, up = torch.chunk(gate_up, 2, dim=-1)
        mlp = up * ACT2FN[cfg.hidden_act](gate)
        mlp = row(mlp, lp["down_proj"], lora=lora_of(lora_layer, "down_proj"), tp=tp,
                  plain=plain)
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
    remat: bool = False,
    lora: Optional[dict] = None,
    tp=None,
) -> DecoderOutput:
    """``collect_layer_id`` uses HF hidden_states indexing (0 = embeddings,
    i = output of layer i, pre-final-norm); ``num_layers`` or None means the
    post-norm last_hidden_state only (``phi3.py:180-225``). Under ``tp`` the
    layers run split (``decoder_layer``); the hidden states between them are
    whole on every rank."""
    cos, sin = rope_cos_sin_for_config(position_ids, cfg, dtype=inputs_embeds.dtype)
    collect = collect_layer_id is not None and collect_layer_id < cfg.num_layers
    collected = inputs_embeds if collect else None  # collect_layer_id == 0

    h = inputs_embeds
    layers = params["layers"]
    for i in range(cfg.num_layers):
        h = stacked_layer(decoder_layer, i, h, layers, cfg, cos, sin, attention_mask, attn_impl,
                          lora=lora, remat=remat, tp=tp)
        if collect and i + 1 == collect_layer_id:
            collected = h

    last = rms_norm(h, params["final_layernorm"], cfg.rms_norm_eps)
    return DecoderOutput(last_hidden_state=last, collected_hidden_state=collected)


def logits(params: dict, lm_head: torch.Tensor, hidden: torch.Tensor) -> torch.Tensor:
    """LM logits for the ptx / SFT regularisers (``phi3.py:228-230``;
    lm_head stored (H, V))."""
    return mm(hidden, lm_head)
