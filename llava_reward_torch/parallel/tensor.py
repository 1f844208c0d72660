"""Tensor parallelism over the mesh's "tp" axis: the column- and row-split
projections every model file calls (Megatron-style).

In the JAX package XLA's SPMD partitioner splits the projections by the
path rules (``parallel/sharding.py``) and inserts the collectives itself.
The port inserts them here, with the same meaning:

- column-split (q/k/v, qkv, gate/up, gate_up, fc1): the input enters the tp
  region once (``enter``: identity, gradient summed over tp) and this rank
  computes its own output columns, so its own heads or MLP columns;
- row-split (o, down, proj, out, fc2): the input is this rank's columns and
  the partial product is summed over tp (``leave_tp``), the bias added once
  after the sum.

The rules give a split projection's kernel to each rank as its block (the
models gather it over fsdp only). A leaf the rules replicate (biases, LoRA
factors, a fused inference layout that matches no rule) reaches the
projection whole: the rank takes its slice through ``enter``, so its
gradient, nonzero on the slice only, is summed over tp into the whole
leaf's. Fused out axes ([q | k | v], [gate | up]) are sliced part by part,
each part's own tp slice (``parts``), which is also how ``shard_params``
lays out a fused kernel's block.

A LoRA delta rides with its base projection: under a column-split base the
rank uses B's columns of its block, under a row-split base A's rows of its
input slice; the row-split delta joins the base's partial sum before the one
all-reduce, which is linear, so the result is exact. A, B and the scale
enter the tp region, as each rank's gradient of them is a partial sum.

A quantized projection (a frozen decoder under ``--load_in_8bit`` /
``--load_in_4bit``) splits the same way. Its leaf reaches the projection as
this rank's block (``shard_params``; ``utils/quantize.tp_block`` slices a
whole one here, with no gradient to carry). A W8A8 block runs the int8 GEMM
on the rank's columns, or on its K-block of a row-split projection, whose
input codes are taken on the tp-global row amax: each rank's raw absmax of
its columns (B6's absmax mode), a MAX all-reduce, then B6 in its given-amax
mode, so that the codes are those the JAX package takes on the whole row,
bit for bit. The quantizing epilogues of the scoring routes do the same:
B4 on the whole row, the same on every rank, into the rank's columns;
B5's codes for down_proj on the tp-global amax (``row_silu_mul``).

tp must divide every head count and MLP width it splits (``check_tp``):
XLA would split any width that divides, heads or not (ROADMAP §C). A 4-bit
decoder also needs each rank's rows of a row-split projection to hold whole
NF4 blocks (64 rows) or whole packed bytes (int4); the JAX package keeps
4-bit leaves whole on every rank.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch

from ..ops import quant_epilogue as qe
from ..ops.linear import mm
from ..utils.quantize import (NF4_BLOCK, int8_linear, int8_linear_pre, is_quantized, is_w8a8,
                              logical_shape, qmatmul, slice_parts, tp_block)
from .collectives import all_reduce_max, enter_tp, leave_tp


class TensorParallel:
    """This rank's place on the tp axis: the axis size, its index and the
    process group of its tp peers."""

    __slots__ = ("size", "rank", "group")

    def __init__(self, mesh):
        self.size, self.rank = mesh.shape["tp"], mesh.coords["tp"]
        self.group = mesh.group(("tp",))

    def __repr__(self) -> str:
        return f"TensorParallel(rank {self.rank} of {self.size})"


def _towers(cfg) -> Dict[str, object]:
    """The family's split stacks: decoder (or text) and vision tower."""
    return {"decoder": cfg.decoder if hasattr(cfg, "decoder") else cfg.text,
            "vision": cfg.vision}


def tp_widths(cfg) -> Dict[str, int]:
    """The head counts and MLP widths that tensor parallelism splits."""
    out = {}
    for name, c in _towers(cfg).items():
        out[f"{name} heads"] = c.num_heads
        if hasattr(c, "num_kv_heads"):
            out[f"{name} kv heads"] = c.num_kv_heads
        out[f"{name} MLP width"] = c.intermediate_size
    return out


def row_split_widths(cfg) -> Dict[str, int]:
    """The 'in' widths of the decoder's row-split projections (the rows a
    rank's block of a quantized o_proj / down_proj divides)."""
    dec = _towers(cfg)["decoder"]
    return {"decoder o_proj in": dec.q_size,
            "decoder down_proj in": dec.intermediate_size}


# a 4-bit decoder's row-split blocks: whole NF4 blocks, whole packed bytes
_ROW_UNIT = {"nf4": NF4_BLOCK, "int4": 2}


def check_tp(cfg, tp: int, quant: Optional[str] = None) -> None:
    """Raise unless ``tp`` divides every width it splits; for a decoder
    quantized ``quant`` ("nf4" or "int4", packed 4-bit codes), unless each
    rank's rows of a row-split projection hold whole NF4 blocks (64 rows) or
    whole bytes of two int4 codes."""
    bad = {k: v for k, v in tp_widths(cfg).items() if v % tp}
    if bad:
        raise ValueError(f"tp {tp} does not divide {bad}: tensor parallelism splits whole "
                         f"heads and MLP columns ({tp_widths(cfg)})")
    unit = _ROW_UNIT.get(quant)
    local = {k: v // tp for k, v in row_split_widths(cfg).items()}
    bad = {k: v for k, v in local.items() if unit and v % unit}
    if bad:
        what = "the 64-row NF4 block" if quant == "nf4" else "2 (two int4 codes a byte)"
        raise ValueError(f"tp {tp} leaves each rank {bad} rows of the {quant} decoder's "
                         f"row-split projections, not a multiple of {what}: a rank's block "
                         f"holds whole blocks (the JAX package keeps 4-bit leaves whole on "
                         f"every tp rank; ROADMAP §C)")


def fused_parts(cfg) -> Dict[str, Sequence[int]]:
    """The part widths of each fused out axis, by the name ``shard_params``
    keys them on: phi3's qkv_proj and gate_up_proj, qwen's vision qkv."""
    dec, vis = _towers(cfg).values()
    return {"qkv": (dec.q_size, dec.kv_size, dec.kv_size),
            "gate_up": (dec.intermediate_size,) * 2,
            "vision_qkv": (vis.hidden_size,) * 3}


def tensor_parallel(mesh, cfg=None) -> Optional[TensorParallel]:
    """This rank's ``TensorParallel`` under ``mesh``, None without a tp
    axis; with ``cfg``, refuse a tp that does not divide its widths."""
    if mesh is None or mesh.shape["tp"] == 1:
        return None
    if cfg is not None:
        check_tp(cfg, mesh.shape["tp"])
    return TensorParallel(mesh)


def local_heads(n: int, tp: Optional[TensorParallel]) -> int:
    """This rank's share of ``n`` heads (or MLP columns)."""
    return n if tp is None else n // tp.size


def enter(x: torch.Tensor, tp: Optional[TensorParallel]) -> torch.Tensor:
    """``x`` into the tp region: its gradient summed over tp."""
    return x if tp is None else enter_tp(x, tp.group)


def local_cols(t, tp: Optional[TensorParallel], parts: Sequence[int], dim: int = -1):
    """This rank's block along ``dim`` (of ``parts``' full widths): a block
    as it is, a whole tensor sliced through ``enter``, a whole quantized leaf
    (``dim`` -1: its columns, -2: its rows) by ``tp_block``."""
    if tp is None:
        return t
    if is_quantized(t) or is_w8a8(t):
        if logical_shape(t)[dim] != sum(parts):
            return t
        return tp_block(t, dim == -2, parts, tp.size, tp.rank)
    if t.shape[dim] != sum(parts):
        return t
    return slice_parts(enter(t, tp), parts, tp.size, tp.rank, dim)


def lora_of(lora_layer: Optional[dict], name: str) -> Optional[dict]:
    """One target's LoRA factors in a layer's adapter slice (the JAX models'
    ``_maybe_lora`` / ``_lora_delta`` hooks), None without them."""
    return None if lora_layer is None else lora_layer.get(name)


def _lora(x: torch.Tensor, t: dict, tp: Optional[TensorParallel], parts=None,
          rows: bool = False) -> torch.Tensor:
    """``x @ A @ B * scale`` in x's dtype (the JAX hooks' casts); under tp
    with B's columns of this rank's block (column-split base, ``parts``) or
    A's rows of its input slice (``rows``)."""
    a, b, s = t["a"], t["b"], t["scale"]
    if tp is not None:
        a, b, s = enter(a, tp), enter(b, tp), enter(s, tp)
        if rows:
            a = slice_parts(a, (a.shape[-2],), tp.size, tp.rank, -2)
        else:
            b = slice_parts(b, parts, tp.size, tp.rank)
    dt = x.dtype
    return mm(mm(x, a.to(dt)), b.to(dt)) * s.to(dt)


def column(x: torch.Tensor, w, bias: Optional[torch.Tensor] = None,
           lora: Optional[dict] = None, *, tp: Optional[TensorParallel] = None,
           parts: Sequence[int] = (), plain: bool = False) -> torch.Tensor:
    """``x @ w (+ bias) (+ LoRA)``, this rank's output columns under tp.
    ``x`` has entered the tp region (``enter``); ``parts`` are the full
    widths of the out axis' fused parts (one part when unfused). ``w`` may
    be quantized: a W8A8 block runs the int8 GEMM on the rank's columns."""
    if tp is not None:
        w = local_cols(w, tp, parts)
        bias = None if bias is None else local_cols(bias, tp, parts)
    out = qmatmul(x, w, plain)
    if bias is not None:
        out = out + bias
    if lora is not None:
        out = out + _lora(x, lora, tp, parts)
    return out


def _tp_amax(x: torch.Tensor, tp: TensorParallel, absmax) -> torch.Tensor:
    """The tp-global row amax of a row split over tp: ``absmax`` of this
    rank's columns (B5 / B6's absmax mode), MAX-reduced over the tp peers."""
    return all_reduce_max(absmax(x.detach()), tp.group)


def row(x: torch.Tensor, w, bias: Optional[torch.Tensor] = None, lora: Optional[dict] = None,
        *, tp: Optional[TensorParallel] = None, plain: bool = False) -> torch.Tensor:
    """``x @ w (+ bias) (+ LoRA)`` with ``x`` this rank's input columns under
    tp: the partial products summed over tp, the bias added after. A W8A8
    ``w`` takes x's codes on the tp-global row amax, on its K-block, and the
    partial products are summed in fp32 and rounded to x's dtype once, as
    one device's GEMM rounds its whole-K sum once."""
    if tp is None:
        out = qmatmul(x, w, plain)
        if bias is not None:
            out = out + bias
        return out if lora is None else out + _lora(x, lora, None)
    w = local_cols(w, tp, (x.shape[-1] * tp.size,), -2)
    if is_w8a8(w):
        x2 = x.reshape(-1, x.shape[-1])
        amax = _tp_amax(x2, tp, qe.row_absmax_plain if plain else qe.row_absmax)
        out = int8_linear(x2, w, plain, amax, torch.float32).reshape(*x.shape[:-1], -1)
    else:
        out = qmatmul(x, w, plain)
    if lora is not None:
        out = out + _lora(x, lora, tp, rows=True)
    out = leave_tp(out, tp.group).to(x.dtype)
    return out if bias is None else out + bias


def row_silu_mul(gate_up: torch.Tensor, w, bias: Optional[torch.Tensor] = None, *,
                 tp: Optional[TensorParallel] = None, plain: bool = False) -> torch.Tensor:
    """A W8A8 down projection of ``silu(gate) * up`` fed by B5's codes
    (inference): ``gate_up`` (..., 2I) fused, under tp this rank's [gate_r |
    up_r], so its I / tp columns are its K-block of ``w``, and the codes are
    taken on their tp-global amax; the partial sums summed over tp in fp32
    (``row``), the bias added after."""
    quant = qe.silu_mul_quant_plain if plain else qe.silu_mul_quant
    if tp is None:
        out = int8_linear_pre(*quant(gate_up), w, gate_up.dtype, plain)
    else:
        w = local_cols(w, tp, (gate_up.shape[-1] // 2 * tp.size,), -2)
        amax = _tp_amax(gate_up, tp, qe.silu_mul_absmax_plain if plain else qe.silu_mul_absmax)
        out = int8_linear_pre(*quant(gate_up, amax), w, torch.float32, plain)
        out = leave_tp(out, tp.group).to(gate_up.dtype)
    return out if bias is None else out + bias
