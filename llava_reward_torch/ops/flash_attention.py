"""Attention kernels of the serving path and their dispatch.

Counterpart of ``llava_reward_tpu/ops/flash_attention.py``. Three TPU
kernels carry Phi-3.5-vision reward scoring; each is a CUDA kernel written
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
=============  ===========================================  ======================

Semantics kept from the TPU kernels: masked scores take the finite fill
``-1e30`` (so a fully masked left-pad row is finite, never NaN); roped q/k
are rounded to the input dtype before the dot; the scale multiplies the fp32
dot; probabilities are rounded to the input dtype before P.V, which
accumulates in fp32. Pad rows are finite but their values depend on which
keys a kernel visits, so only valid rows are compared.

The routing gates are the JAX package's (``fused_path_supported``,
``_direct_path_supported``, ``_direct_group``, the ``B*(H/g) >= 32`` rule,
``_fused_s_pad``), with "on the card" in place of ``_on_tpu()``, so the same
shapes take the same route in both packages.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from ..core.device import on_card

NEG_INF = -1e30
KERNEL_HEAD_DIMS = (64, 96, 128)

LAUNCHES: Dict[str, int] = {"fa_direct": 0, "prep": 0, "fa_hm": 0}
PLAIN_CALLS: Dict[str, int] = {"fa_direct": 0, "prep": 0, "fa_hm": 0}


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
) -> torch.Tensor:
    """Full-row masked softmax attention, one batch row at a time (bounds
    the fp32 (H, S, S) scores). Returns (B, H, S, D) in q's dtype."""
    B, H, S, D = q.shape
    n_rep = H // k.shape[1]
    dev = q.device
    q_pos = torch.arange(S, device=dev)[:, None]
    k_pos = torch.arange(S, device=dev)[None, :]
    base = k_pos < q_len
    if causal:
        base = base & (k_pos <= q_pos)
        if sliding_window is not None:
            base = base & (k_pos > q_pos - sliding_window)
    kv_start = kv_start.to(dev)
    out = torch.empty(B, H, S, D, dtype=q.dtype, device=dev)
    for b in range(B):
        kb = k[b].repeat_interleave(n_rep, dim=0).float()
        vb = v[b].repeat_interleave(n_rep, dim=0).float()
        s = torch.matmul(q[b].float(), kb.transpose(-1, -2)) * scale
        mask = base & (k_pos >= kv_start[b])
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


def flash_fwd_hm_plain(qt, kt, vt, kv_start, *, causal, sliding_window, scale, q_len):
    """Plain version of B3: head-major (B, H, S, D) -> (B, H, S, D)."""
    PLAIN_CALLS["fa_hm"] += 1
    return _attention_core_plain(
        qt, kt, vt, kv_start, causal=causal, sliding_window=sliding_window,
        scale=scale, q_len=q_len,
    )


# --------------------------------------------------------------- kernel launches


def _stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def _check_bf16_cuda(name: str, *ts: torch.Tensor) -> None:
    for t in ts:
        if not t.is_cuda or t.dtype != torch.bfloat16:
            raise ValueError(f"{name}: expects bf16 CUDA tensors, got {t.dtype} on {t.device}")
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: tensor not 16-byte aligned")


def _check_head_dim(name: str, D: int) -> None:
    if D not in KERNEL_HEAD_DIMS:
        raise ValueError(f"{name}: head_dim {D} not in {KERNEL_HEAD_DIMS}")


def _kv_start_i32(kv_start: torch.Tensor, B: int, device) -> torch.Tensor:
    kv = kv_start.to(device=device, dtype=torch.int32).contiguous()
    if kv.shape != (B,):
        raise ValueError(f"kv_start must be ({B},), got {tuple(kv.shape)}")
    return kv


def _rope_tables(cos, sin, B, S, D):
    _check_bf16_cuda("rope tables", cos, sin)
    return cos.expand(B, S, D).contiguous(), sin.expand(B, S, D).contiguous()


def _launch_fa_direct(qkv, cos, sin, kv_start, n_heads, D, causal, window, scale, q_len):
    from . import cuda_lib

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


def _launch_fa_hm(qt, kt, vt, kv_start, causal, window, scale, q_len):
    from . import cuda_lib

    B, H, S, D = qt.shape
    Hk = kt.shape[1]
    _check_head_dim("fa_hm", D)
    if H % Hk or kt.shape != vt.shape or kt.shape[0] != B or kt.shape[2] != S:
        raise ValueError(f"fa_hm: shapes {tuple(qt.shape)} {tuple(kt.shape)} {tuple(vt.shape)}")
    _check_bf16_cuda("fa_hm", qt, kt, vt)
    for t in (qt, kt, vt):
        if t.stride(3) != 1 or any(st % 8 for st in t.stride()[:3]):
            raise ValueError("fa_hm: needs unit last-dim stride and 8-aligned strides")
    kv = _kv_start_i32(kv_start, B, qt.device)
    # written as (B, S, H, D) storage: the (B, S, H*D) view the decoder's
    # o_proj reads is then free
    out = torch.empty(B, S, H, D, dtype=qt.dtype, device=qt.device).permute(0, 2, 1, 3)
    strides = [s for t in (qt, kt, vt, out) for s in t.stride()[:3]]
    err = cuda_lib.load().lrt_fa_hm(
        qt.data_ptr(), kt.data_ptr(), vt.data_ptr(), kv.data_ptr(), out.data_ptr(),
        B, H, Hk, S, D, *strides, q_len, int(causal), window or 0, float(scale), _stream(),
    )
    cuda_lib.check(err, "lrt_fa_hm")
    LAUNCHES["fa_hm"] += 1
    return out


# --------------------------------------------------------------- wrappers


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


def _flash_fwd_hm(qt, kt, vt, kv_start, key_mask, causal, sliding_window, scale, q_len):
    """B3 (``flash_attention.py:262``): head-major (B, H, S, D) q and
    (B, Hk, S, D) k/v -> (B, H, S, D)."""
    if key_mask is not None:
        raise NotImplementedError(
            "key-mask / segment-id attention is ROADMAP slice 5 (Qwen2.5-VL)"
        )
    if not on_card(qt):
        return flash_fwd_hm_plain(
            qt, kt, vt, kv_start, causal=causal, sliding_window=sliding_window,
            scale=scale, q_len=q_len,
        )
    return _launch_fa_hm(qt, kt, vt, kv_start, causal, sliding_window, scale, q_len)


def flash_attention(
    q, k, v, *, causal=False, key_padding_mask=None, sliding_window=None, scale=None,
    mask_layout="leftpad", plain: bool = False,
):
    """(B, S, H, D) entry of B3 (``flash_attention.py:778``), left-pad masks;
    ``plain`` calls B3's plain version on any device."""
    B, S, H, D = q.shape
    if scale is None:
        scale = 1.0 / (D ** 0.5)
    if mask_layout != "leftpad":
        raise NotImplementedError(
            f"mask_layout={mask_layout!r} is ROADMAP slice 5 (Qwen2.5-VL)"
        )
    kv_start = _kv_start_from_mask(key_padding_mask, B, q.device)
    if sliding_window is not None and sliding_window >= S:
        sliding_window = None
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    kw = dict(causal=causal, sliding_window=sliding_window, scale=scale, q_len=S)
    if plain:
        out = flash_fwd_hm_plain(qt, kt, vt, kv_start, **kw)
    else:
        out = _flash_fwd_hm(qt, kt, vt, kv_start, None, **kw)
    return out.transpose(1, 2)


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
    masks only (``kv_start``); the key-mask mode waits for slice 5."""
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
    return _fused_qkv_attention_fwd_impl(
        qkv, cos, sin, kv_start, n_heads=n_heads, n_kv_heads=n_kv_heads,
        head_dim=head_dim, causal=causal, sliding_window=sliding_window, scale=scale,
        plain=plain,
    )
