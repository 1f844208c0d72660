"""Attention kernels of the serving path and their dispatch.

Counterpart of ``llava_reward_tpu/ops/flash_attention.py``. Three TPU
kernels carry reward scoring and a fourth the attention backward of
training; each is a CUDA kernel written
by hand for Hopper in ``llava_reward_torch/csrc/`` (built by
``ops/cuda_lib.py``), with beside it here:

- a plain PyTorch version of the same function (``*_plain``). A wrapper
  takes it only for a tensor that lies on the CPU; for a CUDA tensor it
  launches the kernel or raises. The dispatchers' ``plain=True``
  (``attn_impl="plain"``) calls the plain versions themselves, on any
  device, and goes through no wrapper;
- a launch counter, ``LAUNCHES[name]``, raised by one where the kernel is
  launched and nowhere else (``PLAIN_CALLS[name]`` counts the plain
  version's calls);
- the source note, in the ``.cu`` file: the TPU kernel it replaces, what
  bounds it on the card and what its design does about that.

=============  ===========================================  ======================
name           TPU kernel replaced                          CUDA source
=============  ===========================================  ======================
``fa_direct``  ``_fa_direct_kernel`` (B1), :975-1041         csrc/flash_attention.cu
``prep``       ``_prep_kernel`` (B2), :849-862               csrc/rope_transpose.cu
``fa_hm``      ``_fa_kernel`` (B3), :45-135                  csrc/flash_attention.cu
``fa_bwd``     ``_fa_bwd_kernel`` (B8), :375-488             csrc/flash_attention_bwd.cu
=============  ===========================================  ======================

B8 is the backward of both differentiable entries. ``_FusedCore``
(``_fused_core``, :1249-1299) carries ``fused_qkv_attention``: forward by B1
or B2 x3 + B3, backward by B2 x3 (the roped head-major q/k/v recomputed),
B8, then the VJP of split + RoPE in plain torch ops (XLA in the JAX
package). ``_FlashAttentionCore`` (``_flash_attention_core``, :684-775)
carries the (B, S, H, D) entry ``flash_attention``: forward B3, backward
B8. B8 is three launches, counted as one ``fa_bwd`` call: a row-statistics
pass; a key-stationary pass that adds dq into an fp32 workspace by TMA
reduce-add (and, with GQA, the reps' dk/dv by fp32 atomics); and a pass that
rounds those sums to bf16. Two calls may round a gradient one bf16 step
apart, since the fp32 sums take the order in which blocks finish. Every raw
launch refuses an input that requires grad while grad is enabled
(``cuda_lib.refuse_grad``): the tensors it returns have no ``grad_fn``, so
outside these Functions it would cut the gradient silently.

B3 takes the JAX package's three mask layouts (``flash_attention:778-834``):
left pad (``kv_start``), an arbitrary key mask (``"arbitrary"``, Qwen2.5-VL's
vision windows) and segment ids (``"segments"``, its full-attention blocks:
key k counts for query q iff ``seg[k] != 0 and seg[k] == seg[q]``), with
head_dim 80 beside 64, 96 and 128. B8 takes the same three layouts and head
dims: ``_FlashAttentionCore`` is differentiable in q, k and v in every mode
(``_core_bwd``, :700-713). The segment mode's backward runs when Qwen2.5-VL's
vision tower is trained (full fine-tuning); ``_FusedCore`` is left pad only,
as in the JAX package.

Semantics kept from the TPU kernels: masked scores take the finite fill
``-1e30`` (so a fully masked row, a left-pad query or a pad patch, is
finite, never NaN); roped q/k
are rounded to the input dtype before the dot; the scale multiplies the fp32
dot; probabilities are rounded to the input dtype before P.V, which
accumulates in fp32. Pad rows are finite but their values depend on which
keys a kernel visits, so only valid rows are compared. In the backward a
fully masked query row has a uniform ``p`` (from the same fill), so its
``ds`` and its share of dk/dv are not zero unless ``g`` is zero there; the
plain version and the kernel agree on that share wherever every key tile is
visited (non-causal, no left pad), which the tests hold them to.

The routing gates are the JAX package's (``fused_path_supported``,
``_direct_path_supported``, ``_direct_group``, the ``B*(H/g) >= 32`` rule,
``_fused_s_pad``), with "on the card" in place of ``_on_tpu()``, so the same
shapes take the same route in both packages.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from ..core.device import on_card
from ..utils.profiling import spanned

NEG_INF = -1e30
KERNEL_HEAD_DIMS = (64, 96, 128)
HM_HEAD_DIMS = (64, 80, 96, 128)  # B3 and B8 also take Qwen2.5-VL's vision head_dim

LAUNCHES: Dict[str, int] = {"fa_direct": 0, "prep": 0, "fa_hm": 0, "fa_bwd": 0}
PLAIN_CALLS: Dict[str, int] = {"fa_direct": 0, "prep": 0, "fa_hm": 0, "fa_bwd": 0}


def reset_counters() -> None:
    for d in (LAUNCHES, PLAIN_CALLS):
        for k in d:
            d[k] = 0


# --------------------------------------------------------------- plain versions


def _rope_plain(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x (B, S, n, D), cos/sin (B, S, D): rotate-half RoPE in fp32, one
    rounding to x's dtype (the kernels' order)."""
    D = x.shape[-1]
    half = D // 2
    xf = x.float()
    c = cos.float()[:, :, None, :]
    s = sin.float()[:, :, None, :]
    rot = torch.cat([-xf[..., half:], xf[..., :half]], dim=-1)
    return (xf * c + rot * s).to(x.dtype)


def _base_mask(S, q_len, causal, sliding_window, dev) -> torch.Tensor:
    """(S, S) query x key mask of the q_len tail, causal and window masks
    (the per-row left pad is added by the callers)."""
    q_pos = torch.arange(S, device=dev)[:, None]
    k_pos = torch.arange(S, device=dev)[None, :]
    base = k_pos < q_len
    if causal:
        base = base & (k_pos <= q_pos)
        if sliding_window is not None:
            base = base & (k_pos > q_pos - sliding_window)
    return base


def _attention_core_plain(
    q: torch.Tensor,  # (B, H, S, D)
    k: torch.Tensor,  # (B, Hk, S, D)
    v: torch.Tensor,
    kv_start: torch.Tensor,  # (B,)
    *,
    causal: bool,
    sliding_window: Optional[int],
    scale: float,
    q_len: int,
    key_mask: Optional[torch.Tensor] = None,  # (B, S): 1 = valid key, or segment ids
    segments: bool = False,
) -> torch.Tensor:
    """Full-row masked softmax attention, one batch row at a time (bounds
    the fp32 (H, S, S) scores). Returns (B, H, S, D) in q's dtype."""
    B, H, S, D = q.shape
    n_rep = H // k.shape[1]
    dev = q.device
    base = _base_mask(S, q_len, causal, sliding_window, dev)
    k_pos = torch.arange(S, device=dev)[None, :]
    kv_start = kv_start.to(dev)
    out = torch.empty(B, H, S, D, dtype=q.dtype, device=dev)
    for b in range(B):
        kb = k[b].repeat_interleave(n_rep, dim=0).float()
        vb = v[b].repeat_interleave(n_rep, dim=0).float()
        s = torch.matmul(q[b].float(), kb.transpose(-1, -2)) * scale
        mask = base & (k_pos >= kv_start[b])
        if key_mask is not None:  # _fa_kernel:96-111
            row = key_mask[b].to(dev)
            mask = mask & (row[None, :] != 0)
            if segments:
                mask = mask & (row[None, :] == row[:, None])
        s = torch.where(mask, s, torch.tensor(NEG_INF, dtype=s.dtype, device=dev))
        e = torch.exp(s - s.amax(dim=-1, keepdim=True))
        p = (e / e.sum(dim=-1, keepdim=True)).to(q.dtype)
        out[b] = torch.matmul(p.float(), vb).to(q.dtype)
    return out


def fa_direct_plain(
    qkv, cos, sin, kv_start, *, n_heads, head_dim, causal, sliding_window, scale,
    valid_len=None,
):
    """Plain version of B1: (B, S, 3*H*D) -> (B, S, H*D)."""
    PLAIN_CALLS["fa_direct"] += 1
    B, S, _ = qkv.shape
    D, qsz = head_dim, n_heads * head_dim
    q = qkv[..., :qsz].reshape(B, S, n_heads, D)
    k = qkv[..., qsz : 2 * qsz].reshape(B, S, n_heads, D)
    v = qkv[..., 2 * qsz : 3 * qsz].reshape(B, S, n_heads, D)
    if cos is not None:
        cos, sin = cos.expand(B, S, D), sin.expand(B, S, D)
        q, k = _rope_plain(q, cos, sin), _rope_plain(k, cos, sin)
    out = _attention_core_plain(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), kv_start,
        causal=causal, sliding_window=sliding_window, scale=scale,
        q_len=valid_len if valid_len is not None else S,
    )
    return out.transpose(1, 2).reshape(B, S, qsz)


def rope_transpose_plain(x, cos, sin, *, col_offset, n_heads, head_dim):
    """Plain version of B2: (B, S, C) -> (B, n_heads, S, head_dim)."""
    PLAIN_CALLS["prep"] += 1
    B, S, _ = x.shape
    h = x[..., col_offset : col_offset + n_heads * head_dim].reshape(B, S, n_heads, head_dim)
    if cos is not None:
        h = _rope_plain(h, cos.expand(B, S, head_dim), sin.expand(B, S, head_dim))
    return h.permute(0, 2, 1, 3).contiguous()


def flash_fwd_hm_plain(qt, kt, vt, kv_start, *, causal, sliding_window, scale, q_len,
                       key_mask=None, segments=False):
    """Plain version of B3: head-major (B, H, S, D) -> (B, H, S, D); with
    ``key_mask`` (B, S) the key-mask mode, or with ``segments`` the
    segment-id mode."""
    PLAIN_CALLS["fa_hm"] += 1
    return _attention_core_plain(
        qt, kt, vt, kv_start, causal=causal, sliding_window=sliding_window,
        scale=scale, q_len=q_len, key_mask=key_mask, segments=segments,
    )


def flash_bwd_plain(qt, kt, vt, gt, kv_start, *, causal, sliding_window, scale, q_len,
                    key_mask=None, segments=False):
    """Plain version of B8: head-major q, g (B, H, S, D) and k, v (B, Hk, S, D)
    -> (dq, dk, dv) in q's dtype, one batch row at a time in the kernel's
    order and rounding (``flash_attention.py:415-488``): fp32 masked scores
    (``key_mask`` (B, S): a key mask, or segment ids with ``segments``) and
    full-row softmax, ``dp = g.V^T``, ``delta = rowsum(p * dp)`` from
    fp32 p, ``ds = p * (dp - delta) * scale``; ds and p rounded to the input
    dtype before the three products, which accumulate in fp32; GQA reps
    summed into their kv head before the one rounding. A fully masked query
    row keeps the uniform p the fill gives it, as in the TPU kernel."""
    PLAIN_CALLS["fa_bwd"] += 1
    B, H, S, D = qt.shape
    Hk = kt.shape[1]
    n_rep = H // Hk
    dt, dev = qt.dtype, qt.device
    base = _base_mask(S, q_len, causal, sliding_window, dev)
    k_pos = torch.arange(S, device=dev)[None, :]
    kv_start = kv_start.to(dev)
    dq = torch.empty(B, H, S, D, dtype=dt, device=dev)
    dk = torch.empty(B, Hk, S, D, dtype=dt, device=dev)
    dv = torch.empty(B, Hk, S, D, dtype=dt, device=dev)
    for b in range(B):
        qb, gb = qt[b].float(), gt[b].float()
        kb = kt[b].repeat_interleave(n_rep, dim=0).float()
        vb = vt[b].repeat_interleave(n_rep, dim=0).float()
        s = torch.matmul(qb, kb.transpose(-1, -2)) * scale
        mask = base & (k_pos >= kv_start[b])
        if key_mask is not None:  # _fa_bwd_kernel:425-431
            row = key_mask[b].to(dev)
            mask = mask & (row[None, :] != 0)
            if segments:
                mask = mask & (row[None, :] == row[:, None])
        s = torch.where(mask, s, torch.tensor(NEG_INF, dtype=s.dtype, device=dev))
        e = torch.exp(s - s.amax(dim=-1, keepdim=True))
        del s
        p = e / e.sum(dim=-1, keepdim=True)
        del e
        dp = torch.matmul(gb, vb.transpose(-1, -2))
        delta = (p * dp).sum(dim=-1, keepdim=True)
        ds = (p * (dp - delta) * scale).to(dt).float()
        del dp
        p = p.to(dt).float()
        dq[b] = torch.matmul(ds, kb).to(dt)
        dk[b] = torch.matmul(ds.transpose(-1, -2), qb).reshape(Hk, n_rep, S, D).sum(1).to(dt)
        dv[b] = torch.matmul(p.transpose(-1, -2), gb).reshape(Hk, n_rep, S, D).sum(1).to(dt)
    return dq, dk, dv


# --------------------------------------------------------------- kernel launches


def _stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def _check_bf16_cuda(name: str, *ts: torch.Tensor) -> None:
    for t in ts:
        if not t.is_cuda or t.dtype != torch.bfloat16:
            raise ValueError(f"{name}: expects bf16 CUDA tensors, got {t.dtype} on {t.device}")
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: tensor not 16-byte aligned")


def _check_head_dim(name: str, D: int, dims=KERNEL_HEAD_DIMS) -> None:
    if D not in dims:
        raise ValueError(f"{name}: head_dim {D} not in {dims}")


def _kv_start_i32(kv_start: torch.Tensor, B: int, device) -> torch.Tensor:
    kv = kv_start.to(device=device, dtype=torch.int32).contiguous()
    if kv.shape != (B,):
        raise ValueError(f"kv_start must be ({B},), got {tuple(kv.shape)}")
    return kv


def _rope_tables(cos, sin, B, S, D):
    _check_bf16_cuda("rope tables", cos, sin)
    return cos.expand(B, S, D).contiguous(), sin.expand(B, S, D).contiguous()


def _mask_i32(name: str, key_mask, segments: bool, B: int, S: int, device):
    """(lrt_fa_hm's / lrt_fa_bwd's mask_mode, the int32 row or None): the
    (B, S) row padded with zeros to whole 64-key tiles, (B, S_pad), as the
    kernels fetch a tile's ints by bulk copy."""
    if key_mask is None:
        return 0, None
    if tuple(key_mask.shape) != (B, S):
        raise ValueError(f"{name}: key_mask must be ({B}, {S}), got {tuple(key_mask.shape)}")
    row = key_mask.to(device=device, dtype=torch.int32)
    return (2 if segments else 1), torch.nn.functional.pad(row, (0, _round_up(S, 64) - S))


def _launch_fa_direct(qkv, cos, sin, kv_start, n_heads, D, causal, window, scale, q_len):
    from . import cuda_lib

    cuda_lib.refuse_grad(
        "fa_direct", qkv, cos, sin,
        route="the decoder goes through _FusedCore (fused_qkv_attention); a CLIP tower "
        "with trainable weights goes through mha -> _FlashAttentionCore",
    )
    B, S, C = qkv.shape
    _check_head_dim("fa_direct", D)
    if C != 3 * n_heads * D or not qkv.is_contiguous():
        raise ValueError(f"fa_direct: qkv must be contiguous (B, S, {3 * n_heads * D})")
    _check_bf16_cuda("fa_direct", qkv)
    kv = _kv_start_i32(kv_start, B, qkv.device)
    cp = sp = None
    if cos is not None:
        cos, sin = _rope_tables(cos, sin, B, S, D)
        cp, sp = cos.data_ptr(), sin.data_ptr()
    out = torch.empty(B, S, n_heads * D, dtype=qkv.dtype, device=qkv.device)
    err = cuda_lib.load().lrt_fa_direct(
        qkv.data_ptr(), cp, sp, kv.data_ptr(), out.data_ptr(),
        B, S, n_heads, D, q_len, int(causal), window or 0, float(scale), _stream(),
    )
    cuda_lib.check(err, "lrt_fa_direct")
    LAUNCHES["fa_direct"] += 1
    return out


def _launch_rope_transpose(x, cos, sin, col_offset, n_heads, D):
    from . import cuda_lib

    cuda_lib.refuse_grad("prep", x, cos, sin,
                         route="route it through _FusedCore (fused_qkv_attention)")
    B, S, C = x.shape
    _check_head_dim("prep", D)
    if not x.is_contiguous() or col_offset % 8 or col_offset + n_heads * D > C:
        raise ValueError("prep: x must be contiguous with 8-aligned head columns")
    _check_bf16_cuda("prep", x)
    cp = sp = None
    if cos is not None:
        cos, sin = _rope_tables(cos, sin, B, S, D)
        cp, sp = cos.data_ptr(), sin.data_ptr()
    out = torch.empty(B, n_heads, S, D, dtype=x.dtype, device=x.device)
    err = cuda_lib.load().lrt_rope_transpose(
        x.data_ptr(), cp, sp, out.data_ptr(), B, S, C, col_offset, n_heads, D, _stream()
    )
    cuda_lib.check(err, "lrt_rope_transpose")
    LAUNCHES["prep"] += 1
    return out


def _launch_fa_hm(qt, kt, vt, kv_start, causal, window, scale, q_len, key_mask=None,
                  segments=False):
    from . import cuda_lib

    cuda_lib.refuse_grad(
        "fa_hm", qt, kt, vt,
        route="route it through _FlashAttentionCore (flash_attention) or _FusedCore "
        "(fused_qkv_attention)",
    )
    B, H, S, D = qt.shape
    Hk = kt.shape[1]
    _check_head_dim("fa_hm", D, HM_HEAD_DIMS)
    if H % Hk or kt.shape != vt.shape or kt.shape[0] != B or kt.shape[2] != S:
        raise ValueError(f"fa_hm: shapes {tuple(qt.shape)} {tuple(kt.shape)} {tuple(vt.shape)}")
    _check_bf16_cuda("fa_hm", qt, kt, vt)
    for t in (qt, kt, vt):
        if t.stride(3) != 1 or any(st % 8 for st in t.stride()[:3]):
            raise ValueError("fa_hm: needs unit last-dim stride and 8-aligned strides")
    kv = _kv_start_i32(kv_start, B, qt.device)
    mode, key_mask = _mask_i32("fa_hm", key_mask, segments, B, S, qt.device)
    mp = key_mask.data_ptr() if key_mask is not None else None
    # written as (B, S, H, D) storage: the (B, S, H*D) view the decoder's
    # o_proj reads is then free
    out = torch.empty(B, S, H, D, dtype=qt.dtype, device=qt.device).permute(0, 2, 1, 3)
    strides = [s for t in (qt, kt, vt, out) for s in t.stride()[:3]]
    err = cuda_lib.load().lrt_fa_hm(
        qt.data_ptr(), kt.data_ptr(), vt.data_ptr(), kv.data_ptr(), mp, out.data_ptr(),
        B, H, Hk, S, D, *strides, q_len, int(causal), window or 0, mode, float(scale),
        _stream(),
    )
    cuda_lib.check(err, "lrt_fa_hm")
    LAUNCHES["fa_hm"] += 1
    return out


def _launch_fa_bwd(qt, kt, vt, gt, kv_start, causal, window, scale, q_len, key_mask=None,
                   segments=False):
    from . import cuda_lib

    cuda_lib.refuse_grad("fa_bwd", qt, kt, vt, gt,
                         route="it runs inside the backward of _FusedCore / _FlashAttentionCore")
    B, H, S, D = qt.shape
    Hk = kt.shape[1]
    _check_head_dim("fa_bwd", D, HM_HEAD_DIMS)
    if (H % Hk or kt.shape != vt.shape or gt.shape != qt.shape or kt.shape[0] != B
            or kt.shape[2] != S):
        raise ValueError(f"fa_bwd: shapes q {tuple(qt.shape)} k {tuple(kt.shape)} "
                         f"v {tuple(vt.shape)} g {tuple(gt.shape)}")
    _check_bf16_cuda("fa_bwd", qt, kt, vt, gt)
    for t in (qt, kt, vt, gt):
        if t.stride(3) != 1 or any(st % 8 for st in t.stride()[:3]):
            raise ValueError("fa_bwd: needs unit last-dim stride and 8-aligned strides")
    kv = _kv_start_i32(kv_start, B, qt.device)
    mode, key_mask = _mask_i32("fa_bwd", key_mask, segments, B, S, qt.device)
    # scratch, padded to whole 64-row tiles: the row statistics, which the
    # main pass fetches by bulk copy, and the zeroed fp32 sums of dq and, with
    # GQA, of dk and dv over the reps
    S_pad = _round_up(S, 64)
    mp = key_mask.data_ptr() if key_mask is not None else None
    # written as (B, S, H, D) storage, like B3's output: the callers' (B, S, ...)
    # layouts are then free
    dq = torch.empty(B, S, H, D, dtype=qt.dtype, device=qt.device).permute(0, 2, 1, 3)
    dk = torch.empty(B, S, Hk, D, dtype=qt.dtype, device=qt.device).permute(0, 2, 1, 3)
    dv = torch.empty(B, S, Hk, D, dtype=qt.dtype, device=qt.device).permute(0, 2, 1, 3)
    stats = torch.empty(3 * B * H * S_pad, dtype=torch.float32, device=qt.device)
    acc = torch.zeros((B * H + (2 * B * Hk if H != Hk else 0)) * S_pad * D, dtype=torch.float32,
                      device=qt.device)
    strides = torch.tensor(
        [st for t in (qt, kt, vt, gt, dq, dk, dv) for st in t.stride()[:3]], dtype=torch.int64
    )
    err = cuda_lib.load().lrt_fa_bwd(
        qt.data_ptr(), kt.data_ptr(), vt.data_ptr(), gt.data_ptr(), kv.data_ptr(),
        dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), stats.data_ptr(), acc.data_ptr(), mp,
        B, H, Hk, S, D, strides.data_ptr(), q_len, int(causal), window or 0, mode,
        float(scale), _stream(),
    )
    cuda_lib.check(err, "lrt_fa_bwd")
    LAUNCHES["fa_bwd"] += 1
    return dq, dk, dv


# --------------------------------------------------------------- wrappers


@spanned("attn")
def _fused_qkv_attention_direct(
    qkv, cos, sin, kv_start, *, n_heads, head_dim, causal, sliding_window, scale,
    valid_len: Optional[int] = None,
):
    """B1 (``flash_attention.py:1067``): (B, S, 3*H*D) -> (B, S, H*D)."""
    if not on_card(qkv):
        return fa_direct_plain(
            qkv, cos, sin, kv_start, n_heads=n_heads, head_dim=head_dim, causal=causal,
            sliding_window=sliding_window, scale=scale, valid_len=valid_len,
        )
    q_len = valid_len if valid_len is not None else qkv.shape[1]
    return _launch_fa_direct(
        qkv, cos, sin, kv_start, n_heads, head_dim, causal, sliding_window, scale, q_len
    )


# the public name of B1's entry (``flash_attention.py:1172``), used by CLIP
direct_attention = _fused_qkv_attention_direct


def rope_transpose(x, cos, sin, *, col_offset, n_heads, head_dim):
    """B2 (``flash_attention.py:881``): -> (B, n_heads, S, head_dim), roped
    iff cos is not None."""
    if not on_card(x):
        return rope_transpose_plain(
            x, cos, sin, col_offset=col_offset, n_heads=n_heads, head_dim=head_dim
        )
    return _launch_rope_transpose(x, cos, sin, col_offset, n_heads, head_dim)


def _flash_fwd_hm(qt, kt, vt, kv_start, key_mask, causal, sliding_window, scale, q_len,
                  segments=False):
    """B3 (``flash_attention.py:262``): head-major (B, H, S, D) q and
    (B, Hk, S, D) k/v -> (B, H, S, D). ``key_mask`` (B, S) or None: a key
    mask (1 = valid), or segment ids (0 = pad) with ``segments``."""
    if not on_card(qt):
        return flash_fwd_hm_plain(
            qt, kt, vt, kv_start, causal=causal, sliding_window=sliding_window,
            scale=scale, q_len=q_len, key_mask=key_mask, segments=segments,
        )
    return _launch_fa_hm(qt, kt, vt, kv_start, causal, sliding_window, scale, q_len,
                         key_mask, segments)


def flash_bwd(qt, kt, vt, gt, kv_start, *, causal, sliding_window, scale, q_len,
              key_mask=None, segments=False):
    """B8 (``flash_attention.py:502``): head-major q, g (B, H, S, D) and
    k, v (B, Hk, S, D) -> (dq, dk, dv) head-major. ``key_mask`` (B, S) or
    None: a key mask (1 = valid), or segment ids (0 = pad) with ``segments``."""
    if not on_card(qt):
        return flash_bwd_plain(qt, kt, vt, gt, kv_start, causal=causal,
                               sliding_window=sliding_window, scale=scale, q_len=q_len,
                               key_mask=key_mask, segments=segments)
    return _launch_fa_bwd(qt, kt, vt, gt, kv_start, causal, sliding_window, scale, q_len,
                          key_mask, segments)


class _FlashAttentionCore(torch.autograd.Function):
    """``_flash_attention_core`` (``flash_attention.py:684-775``) on
    (B, S, H, D) q and (B, S, Hk, D) k/v: forward B3, backward B8, in
    every mask mode. With ``plain`` both directions call the plain versions,
    on any device."""

    @staticmethod
    def forward(ctx, q, k, v, kv_start, key_mask, causal, sliding_window, scale, plain,
                segments):
        kw = dict(causal=causal, sliding_window=sliding_window, scale=scale, q_len=q.shape[1])
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        if plain:
            out = flash_fwd_hm_plain(qt, kt, vt, kv_start, key_mask=key_mask,
                                     segments=segments, **kw)
        else:
            out = _flash_fwd_hm(qt, kt, vt, kv_start, key_mask, segments=segments, **kw)
        ctx.save_for_backward(q, k, v, kv_start, key_mask)
        ctx.kw, ctx.plain, ctx.segments = kw, plain, segments
        return out.transpose(1, 2)

    @staticmethod
    def backward(ctx, g):
        q, k, v, kv_start, key_mask = ctx.saved_tensors
        bwd = flash_bwd_plain if ctx.plain else flash_bwd
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        dq, dk, dv = bwd(qt, kt, vt, g.contiguous().transpose(1, 2), kv_start,
                         key_mask=key_mask, segments=ctx.segments, **ctx.kw)
        return (dq.transpose(1, 2), dk.transpose(1, 2), dv.transpose(1, 2),
                None, None, None, None, None, None, None)


def flash_attention(
    q, k, v, *, causal=False, key_padding_mask=None, sliding_window=None, scale=None,
    mask_layout="leftpad", plain: bool = False,
):
    """(B, S, H, D) entry of B3 / B8 (``flash_attention.py:778-834``);
    ``plain`` calls the plain versions on any device. ``mask_layout``:
    "leftpad" (valid keys form a suffix: one ``kv_start`` per row),
    "arbitrary" (any key-valid pattern) or "segments" (``key_padding_mask``
    holds segment ids, 0 = pad). Differentiable in q, k and v in all three."""
    B, S, H, D = q.shape
    if scale is None:
        scale = 1.0 / (D ** 0.5)
    kv_start = torch.zeros(B, dtype=torch.int32, device=q.device)
    key_mask = None
    if key_padding_mask is not None:
        if mask_layout in ("arbitrary", "segments"):
            key_mask = key_padding_mask.to(torch.int32)
        elif mask_layout == "leftpad":
            kv_start = _kv_start_from_mask(key_padding_mask, B, q.device)
        else:
            raise ValueError(f"unknown mask_layout {mask_layout!r}")
    if sliding_window is not None and sliding_window >= S:
        sliding_window = None
    D_pad = D if plain or not on_card(q) else padded_head_dim(D)
    if D_pad != D:  # zero columns add nothing to q.k, and give zero output columns
        q, k, v = (torch.nn.functional.pad(t, (0, D_pad - D)) for t in (q, k, v))
    out = _FlashAttentionCore.apply(q, k, v, kv_start, key_mask, causal, sliding_window, scale,
                                    plain, key_mask is not None and mask_layout == "segments")
    return out[..., :D] if D_pad != D else out


def padded_head_dim(D: int) -> int:
    """The head_dim B3 and B8 run a head of ``D`` at: the smallest of
    ``HM_HEAD_DIMS`` that holds it (the Pallas kernels zero-pad head_dim to a
    lane multiple, ``flash_attention.py:329-343``), else ``D`` itself, which
    the launch refuses."""
    return next((d for d in HM_HEAD_DIMS if d >= D), D)


def _kv_start_from_mask(mask, B, device):
    """Number of left pads == first valid index (``flash_attention.py:1322-1325``)."""
    if mask is None:
        return torch.zeros(B, dtype=torch.int32, device=device)
    return torch.sum(1 - mask.to(torch.int32), dim=-1).to(torch.int32)


# --------------------------------------------------------------- routing gates


def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


def _prep_group_size(n_heads: int, D: int) -> Optional[int]:
    for g in (16, 8, 4, 2, 1):
        if n_heads % g == 0 and (g * D) % 128 == 0:
            return g
    return None


def _prep_block_s(S: int) -> Optional[int]:
    for bs in (512, 256, 320, 128, 64, 8):
        if S % bs == 0:
            return bs
    return None


def fused_path_supported(S: int, n_heads: int, n_kv_heads: int, head_dim: int) -> bool:
    """``flash_attention.py:939-951``."""
    if _prep_group_size(n_heads, head_dim) is None:
        return False
    if n_kv_heads != n_heads and _prep_group_size(n_kv_heads, head_dim) is None:
        return False
    return head_dim % 32 == 0


def _fused_s_pad(S: int) -> int:
    """``flash_attention.py:954-961``."""
    if S % 64 == 0 and _prep_block_s(S) is not None:
        return S
    return _round_up(S, 256)


def _direct_group(n_heads: int, D: int) -> Optional[int]:
    """``flash_attention.py:1044-1050``."""
    for g in (1, 2, 4, 8):
        if n_heads % g == 0 and (g * D) % 128 == 0:
            return g
    return None


def _direct_path_supported(S, n_heads, n_kv_heads, head_dim, key_mask, sliding_window) -> bool:
    """``flash_attention.py:1053-1064``."""
    return (
        n_heads == n_kv_heads
        and key_mask is None
        and _direct_group(n_heads, head_dim) is not None
        and head_dim % 2 == 0
        and S % 64 == 0
    )


def _fused_qkv_attention_fwd_impl(
    qkv, cos, sin, kv_start, *, n_heads, n_kv_heads, head_dim, causal, sliding_window,
    scale, plain: bool = False,
):
    """``flash_attention.py:1200-1246``: B1 when MHA and B*(H/g) >= 32,
    otherwise B2 three times and B3. ``plain`` calls the three kernels'
    plain versions instead of their wrappers, on any device. Left-pad
    masks only (``kv_start``): the decoders' masks. The key-mask and segment
    modes reach B3 through ``flash_attention``."""
    B, S, _ = qkv.shape
    D = head_dim
    qsz, kvsz = n_heads * D, n_kv_heads * D
    S_orig = S
    S_pad = _fused_s_pad(S)
    if S_pad != S:
        pad = (0, 0, 0, S_pad - S)
        qkv = torch.nn.functional.pad(qkv, pad)
        cos = torch.nn.functional.pad(cos.expand(B, S, D), pad)
        sin = torch.nn.functional.pad(sin.expand(B, S, D), pad)
        S = S_pad
    if _direct_path_supported(S, n_heads, n_kv_heads, D, None, sliding_window):
        g = _direct_group(n_heads, D)
        if B * (n_heads // g) >= 32:
            direct = fa_direct_plain if plain else _fused_qkv_attention_direct
            out = direct(
                qkv, cos, sin, kv_start, n_heads=n_heads, head_dim=D, causal=causal,
                sliding_window=sliding_window, scale=scale,
                valid_len=S_orig if S_orig != S else None,
            )
            return out[:, :S_orig] if S_orig != S else out
    prep = rope_transpose_plain if plain else rope_transpose
    qt = prep(qkv, cos, sin, col_offset=0, n_heads=n_heads, head_dim=D)
    kt = prep(qkv, cos, sin, col_offset=qsz, n_heads=n_kv_heads, head_dim=D)
    vt = prep(qkv, None, None, col_offset=qsz + kvsz, n_heads=n_kv_heads, head_dim=D)
    kw = dict(causal=causal, sliding_window=sliding_window, scale=scale, q_len=S_orig)
    if plain:
        out = flash_fwd_hm_plain(qt, kt, vt, kv_start, **kw)
    else:
        out = _flash_fwd_hm(qt, kt, vt, kv_start, None, **kw)
    out = out.transpose(1, 2).reshape(B, S, qsz)  # (B, H, S, D) -> (B, S, H*D)
    return out[:, :S_orig] if S_orig != S else out


def fused_qkv_attention(
    qkv, cos, sin, *, n_heads, n_kv_heads, head_dim, causal=True, key_padding_mask=None,
    sliding_window=None, scale=None, plain: bool = False,
):
    """``flash_attention.py:1302-1345``: RoPE + attention straight from the
    fused qkv projection -> (B, S, n_heads*head_dim). Left-pad masks only:
    the mask becomes ``kv_start = sum(1 - mask)``."""
    B, S, _ = qkv.shape
    if scale is None:
        scale = 1.0 / (head_dim ** 0.5)
    kv_start = _kv_start_from_mask(key_padding_mask, B, qkv.device)
    if sliding_window is not None and sliding_window >= S:
        sliding_window = None
    meta = dict(n_heads=n_heads, n_kv_heads=n_kv_heads, head_dim=head_dim, causal=causal,
                sliding_window=sliding_window, scale=scale, plain=plain)
    return _FusedCore.apply(qkv, cos, sin, kv_start, meta)


def _rope_vjp(d: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """VJP of rotate-half RoPE (``rope.py:apply_rotary``) for d (B, S, n, D):
    ``d * cos + rot^T(d * sin)`` with ``rot^T(t) = [t2, -t1]``, in fp32 with
    one rounding to d's dtype."""
    half = d.shape[-1] // 2
    df = d.float()
    t = df * sin.float()[:, :, None, :]
    return (df * cos.float()[:, :, None, :]
            + torch.cat([t[..., half:], -t[..., :half]], dim=-1)).to(d.dtype)


def _fused_core_bwd(qkv, cos, sin, kv_start, g, *, n_heads, n_kv_heads, head_dim, causal,
                    sliding_window, scale, plain):
    """``_fused_core_bwd`` (``flash_attention.py:1269-1296``): the roped
    head-major q/k/v recomputed by B2, B8, then the VJP of split + RoPE.
    Returns dqkv (B, S, q_size + 2*kv_size)."""
    B, S, _ = qkv.shape
    D = head_dim
    qsz, kvsz = n_heads * D, n_kv_heads * D
    cos, sin = cos.expand(B, S, D), sin.expand(B, S, D)
    g = g.contiguous()
    S_pad = _fused_s_pad(S)
    if S_pad != S:  # the forward's end padding; pad rows take a zero gradient
        pad = (0, 0, 0, S_pad - S)
        qkv_p, cos_p, sin_p, g = (torch.nn.functional.pad(t, pad) for t in (qkv, cos, sin, g))
    else:
        qkv_p, cos_p, sin_p = qkv, cos, sin
    prep = rope_transpose_plain if plain else rope_transpose
    qt = prep(qkv_p, cos_p, sin_p, col_offset=0, n_heads=n_heads, head_dim=D)
    kt = prep(qkv_p, cos_p, sin_p, col_offset=qsz, n_heads=n_kv_heads, head_dim=D)
    vt = prep(qkv_p, None, None, col_offset=qsz + kvsz, n_heads=n_kv_heads, head_dim=D)
    gt = g.view(B, S_pad, n_heads, D).transpose(1, 2)
    bwd = flash_bwd_plain if plain else flash_bwd
    dq, dk, dv = bwd(qt, kt, vt, gt, kv_start, causal=causal,
                     sliding_window=sliding_window, scale=scale, q_len=S)
    dq, dk, dv = (t.transpose(1, 2)[:, :S] for t in (dq, dk, dv))  # (B, S, n, D)
    return torch.cat([
        _rope_vjp(dq, cos, sin).reshape(B, S, qsz),
        _rope_vjp(dk, cos, sin).reshape(B, S, kvsz),
        dv.reshape(B, S, kvsz),
    ], dim=-1)


class _FusedCore(torch.autograd.Function):
    """``_fused_core`` (``flash_attention.py:1249-1299``): RoPE + attention
    straight from the fused qkv, forward by B1 or B2 x3 + B3, backward by
    ``_fused_core_bwd``. cos and sin take no gradient, as the JAX package's
    zeros."""

    @staticmethod
    def forward(ctx, qkv, cos, sin, kv_start, meta):
        ctx.save_for_backward(qkv, cos, sin, kv_start)
        ctx.meta = meta
        return _fused_qkv_attention_fwd_impl(qkv, cos, sin, kv_start, **meta)

    @staticmethod
    def backward(ctx, g):
        qkv, cos, sin, kv_start = ctx.saved_tensors
        return _fused_core_bwd(qkv, cos, sin, kv_start, g, **ctx.meta), None, None, None, None
