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

tp must divide every head count and MLP width it splits (``check_tp``):
XLA would split any width that divides, heads or not (ROADMAP §C).
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch

from ..ops.linear import mm
from ..utils.quantize import qmatmul
from .collectives import enter_tp, leave_tp


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


def check_tp(cfg, tp: int) -> None:
    """Raise unless ``tp`` divides every width it splits."""
    bad = {k: v for k, v in tp_widths(cfg).items() if v % tp}
    if bad:
        raise ValueError(f"tp {tp} does not divide {bad}: tensor parallelism splits whole "
                         f"heads and MLP columns ({tp_widths(cfg)})")


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
    """This rank's share of ``n`` heads."""
    return n if tp is None else n // tp.size


def enter(x: torch.Tensor, tp: Optional[TensorParallel]) -> torch.Tensor:
    """``x`` into the tp region: its gradient summed over tp."""
    return x if tp is None else enter_tp(x, tp.group)


def slice_parts(t: torch.Tensor, parts: Sequence[int], size: int, rank: int,
                dim: int = -1) -> torch.Tensor:
    """Rank ``rank``'s block along ``dim`` of a fused axis of ``parts``:
    every part's own slice of ``1 / size``, in order."""
    blocks = [p.narrow(dim, rank * (p.shape[dim] // size), p.shape[dim] // size)
              for p in t.split(list(parts), dim)]
    return blocks[0] if len(blocks) == 1 else torch.cat(blocks, dim)


def local_cols(t: torch.Tensor, tp: Optional[TensorParallel], parts: Sequence[int],
               dim: int = -1) -> torch.Tensor:
    """This rank's block along ``dim`` (of ``parts``' full widths): a block
    as it is, a whole tensor sliced through ``enter``."""
    if tp is None or t.shape[dim] != sum(parts):
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
    be quantized (no tp then: ROADMAP A9)."""
    if tp is not None:
        w = local_cols(w, tp, parts)
        bias = None if bias is None else local_cols(bias, tp, parts)
    out = qmatmul(x, w, plain)
    if bias is not None:
        out = out + bias
    if lora is not None:
        out = out + _lora(x, lora, tp, parts)
    return out


def row(x: torch.Tensor, w, bias: Optional[torch.Tensor] = None, lora: Optional[dict] = None,
        *, tp: Optional[TensorParallel] = None, plain: bool = False) -> torch.Tensor:
    """``x @ w (+ bias) (+ LoRA)`` with ``x`` this rank's input columns under
    tp: the partial products summed over tp, the bias added after."""
    if tp is None:
        out = qmatmul(x, w, plain)
        if bias is not None:
            out = out + bias
        return out if lora is None else out + _lora(x, lora, None)
    out = qmatmul(x, local_cols(w, tp, (x.shape[-1] * tp.size,), -2), plain)
    if lora is not None:
        out = out + _lora(x, lora, tp, rows=True)
    out = leave_tp(out, tp.group)
    return out if bias is None else out + bias
