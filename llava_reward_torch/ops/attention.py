"""Attention entry points: reference implementation and kernel dispatch.

Counterpart of ``llava_reward_tpu/ops/attention.py``. Layout at the API is
(batch, seq, heads, head_dim), as in the JAX package.

``impl`` values: ``"auto"`` takes the hand-written CUDA kernels when the
tensors lie on the card and the reference otherwise (the JAX package's
``_on_tpu()`` gates); ``"pallas"`` forces the kernel route (on CPU tensors
the kernels' plain versions run, as the JAX package interprets its Pallas
kernels on the CPU); ``"plain"`` takes the kernel route but calls each
kernel's plain PyTorch version, also on the card; ``"xla"`` is the reference.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..core.device import on_card

NEG_INF = -0.7 * float(torch.finfo(torch.float32).max)


def _build_bias(
    q_len: int,
    kv_len: int,
    causal: bool,
    key_padding_mask: Optional[torch.Tensor],  # (B, kv_len) 1=valid
    sliding_window: Optional[int],
    device: torch.device,
    dtype: torch.dtype = torch.float32,
    segment_ids: Optional[torch.Tensor] = None,  # (B, kv_len) 0=pad
) -> Optional[torch.Tensor]:
    """Additive attention bias (B or 1, 1, q_len, kv_len)."""
    bias = None
    q_pos = torch.arange(q_len, device=device)[:, None] + (kv_len - q_len)
    k_pos = torch.arange(kv_len, device=device)[None, :]
    zero = torch.tensor(0.0, dtype=dtype, device=device)
    neg = torch.tensor(NEG_INF, dtype=dtype, device=device)
    if causal:
        allowed = k_pos <= q_pos
        if sliding_window is not None and sliding_window < kv_len:
            allowed = allowed & (k_pos > q_pos - sliding_window)
        bias = torch.where(allowed, zero, neg)[None, None]
    if segment_ids is not None:
        seg = segment_ids.to(torch.int32)
        ok = (seg[:, :, None] == seg[:, None, :]) & (seg[:, None, :] != 0)
        sm = torch.where(ok, zero, neg)[:, None]
        bias = sm if bias is None else bias + sm
    if key_padding_mask is not None:
        pm = torch.where(key_padding_mask.bool(), zero, neg)[:, None, None, :]
        bias = pm if bias is None else bias + pm
    return bias


def attention_reference(
    q: torch.Tensor,  # (B, Sq, H, D)
    k: torch.Tensor,  # (B, Skv, Hk, D)
    v: torch.Tensor,
    *,
    causal: bool = False,
    key_padding_mask: Optional[torch.Tensor] = None,
    sliding_window: Optional[int] = None,
    scale: Optional[float] = None,
    segment_ids: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Plain attention with an fp32 softmax (``attention.py:55-85``). GQA
    by head broadcasting; scores accumulate in fp32."""
    B, Sq, H, D = q.shape
    _, Skv, Hk, _ = k.shape
    if scale is None:
        scale = 1.0 / (D ** 0.5)
    n_rep = H // Hk
    qh = q.reshape(B, Sq, Hk, n_rep, D).float()
    scores = torch.einsum("bqhrd,bkhd->bhrqk", qh, k.float()) * scale
    bias = _build_bias(
        Sq, Skv, causal, key_padding_mask, sliding_window, q.device,
        segment_ids=segment_ids,
    )
    if bias is not None:
        scores = scores + bias[:, :, None]
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    out = torch.einsum("bhrqk,bkhd->bqhrd", probs, v)
    return out.reshape(B, Sq, H, D)


def mha(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = False,
    key_padding_mask: Optional[torch.Tensor] = None,
    sliding_window: Optional[int] = None,
    scale: Optional[float] = None,
    impl: str = "auto",
    mask_layout: str = "leftpad",
) -> torch.Tensor:
    """Dispatch (``attention.py:88-145``): the head-major kernel (B3) on the
    card, the reference elsewhere."""
    if impl in ("auto", "plain"):
        use_kernel = on_card(q)
        # tiny bidirectional rows stay on the reference, as in JAX
        if use_kernel and not causal and q.shape[1] < 256:
            use_kernel = False
        if not use_kernel:
            impl = "xla"
    if impl in ("pallas", "plain"):
        from .flash_attention import flash_attention

        return flash_attention(
            q, k, v, causal=causal, key_padding_mask=key_padding_mask,
            sliding_window=sliding_window, scale=scale, mask_layout=mask_layout,
            plain=impl == "plain",
        )
    if mask_layout == "segments":
        return attention_reference(
            q, k, v, causal=causal, sliding_window=sliding_window,
            scale=scale, segment_ids=key_padding_mask,
        )
    return attention_reference(
        q, k, v, causal=causal, key_padding_mask=key_padding_mask,
        sliding_window=sliding_window, scale=scale,
    )


def fused_rope_attention(
    qkv: torch.Tensor,  # (B, S, q_size + 2*kv_size)
    cos: torch.Tensor,  # (B, S, head_dim)
    sin: torch.Tensor,
    *,
    n_heads: int,
    n_kv_heads: int,
    head_dim: int,
    causal: bool = True,
    key_padding_mask: Optional[torch.Tensor] = None,  # left-pad convention
    sliding_window: Optional[int] = None,
    scale: Optional[float] = None,
    impl: str = "auto",
) -> torch.Tensor:
    """Decoder attention straight from the fused qkv projection ->
    (B, S, n_heads*head_dim) (``attention.py:148-203``). On the card, when
    the shapes allow, the fused kernel path (B1, or B2 + B3); elsewhere
    split + rope + mha."""
    B, S, _ = qkv.shape
    qsz = n_heads * head_dim
    kvsz = n_kv_heads * head_dim

    if impl in ("auto", "pallas", "plain"):
        from .flash_attention import fused_path_supported, fused_qkv_attention

        if (impl == "pallas" or on_card(qkv)) and fused_path_supported(
            S, n_heads, n_kv_heads, head_dim
        ):
            return fused_qkv_attention(
                qkv, cos, sin,
                n_heads=n_heads, n_kv_heads=n_kv_heads, head_dim=head_dim,
                causal=causal, key_padding_mask=key_padding_mask,
                sliding_window=sliding_window, scale=scale, plain=impl == "plain",
            )

    from .rope import apply_rotary

    q = qkv[..., :qsz].reshape(B, S, n_heads, head_dim)
    k = qkv[..., qsz : qsz + kvsz].reshape(B, S, n_kv_heads, head_dim)
    v = qkv[..., qsz + kvsz :].reshape(B, S, n_kv_heads, head_dim)
    q, k = apply_rotary(q, k, cos, sin)
    out = mha(
        q, k, v, causal=causal, key_padding_mask=key_padding_mask,
        sliding_window=sliding_window, scale=scale, impl=impl,
    )
    return out.reshape(B, S, qsz)
