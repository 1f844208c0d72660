"""Mesh and parameter sharding over processes, one device each (the port's
copy of ``llava_reward_tpu/parallel/sharding.py``).

The mesh has the JAX package's axes:

  dp    data parallel (parameters replicated)        -- ZeRO-0
  fsdp  parameters and optimizer state sharded       -- ZeRO-3
  tp    tensor parallel over heads and MLP columns   (``parallel/tensor.py``)

Rank r sits at the row-major position of ``arange(world).reshape(dp, fsdp,
tp)`` (``sharding.py:40``), so rank = (dp_i * fsdp + fsdp_i) * tp + tp_i.
The sizes and this rank's coordinates are kept apart from the process
groups, which are built on first use: rules and shard shapes need no
process group.

Sharding is decided by the JAX package's path rules over the param tree
(``_PARAM_RULES``, a spec being a tuple of axis names per dim), with any dim
the mesh does not divide replicated (``_divisible_spec``). ``shard_params``
keeps, on each rank, its block of every leaf that its spec shards over
"fsdp" or "tp", wrapped in ``Sharded``; every other leaf stays whole. A
fused out axis ([q | k | v], [gate | up]) split over tp holds, on rank r,
every part's own r-th slice side by side, so each rank's block is its own
heads (``_FUSED``); saving and resuming undo and redo that order, so a
checkpoint is the JAX layout whatever the mesh. Under tp, the model's
heads, kv heads and MLP widths must divide by tp.

A quantized leaf ({'qvalues_*', 'scale'}, a frozen decoder under
``--load_in_8bit`` / ``--load_in_4bit``) matches no JAX rule, so JAX keeps it
whole on every rank and XLA slices what each rank's heads use. Here each tp
rank keeps its block instead (``utils/quantize.tp_block``), split on the
dim its float kernel's rule splits over tp (and the fused inference layout
of the qwen / LLaVA decoders, which no rule places, as the projections it
fuses): each split entry a ``Sharded`` on "tp" alone, so that ``full`` and
``gather_tree`` give the whole leaf in the JAX layout (W8A8 codes K-major).
Over fsdp a quantized leaf stays whole, as JAX's rules keep it.

Models gather a ``Sharded`` leaf where they use it: a stacked layer over
fsdp only (``layer``, inside ``models/clip_vit.layer_slice``), keeping its
tp block for the column- or row-split projection; any other leaf whole
(``full``, through ``gather_unstacked``): leaves used whole (embeddings,
projectors, SkipCA) are gathered over tp too, with a backward that keeps
this rank's block of the gradient unsummed, as the tp peers compute the
same one. The fsdp gather's backward reduce-scatters its gradient.

Batches shard over ("dp", "fsdp"): data rank d = dp_i * fsdp + fsdp_i takes
rows [d * B / n, (d + 1) * B / n), axis 1 for the M-RoPE ``position_ids``
(3, B, S), the global row order of JAX's ``shard_batch``; the tp peers of a
data rank hold the same rows. A rank that loads its own rows (the train
CLI's per-rank sampler) holds its shard already.
"""

from __future__ import annotations

import math
import re
from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from ..utils.quantize import (is_quantized, is_w8a8, k_major, logical_shape, tp_block,
                              tp_block_dims)
from .collectives import gather_shard, gather_whole
from .tensor import check_tp, fused_parts, slice_parts

AXES = ("dp", "fsdp", "tp")
DATA = ("dp", "fsdp")
Spec = Tuple  # one entry per dim: None, an axis name, or a tuple of names


class Mesh:
    """Axis sizes, this rank's coordinates, and the process groups along
    any set of axes (built on first use, every group of that set in the
    same order on every rank, as ``new_group`` requires)."""

    def __init__(self, dp: int, fsdp: int, tp: int, rank: int = 0):
        self.shape: Dict[str, int] = {"dp": dp, "fsdp": fsdp, "tp": tp}
        self.size = dp * fsdp * tp
        if not 0 <= rank < self.size:
            raise ValueError(f"rank {rank} outside a mesh of {self.size}")
        self.rank = rank
        self.coords = {"dp": rank // (fsdp * tp), "fsdp": rank // tp % fsdp, "tp": rank % tp}
        self._groups: Dict[Tuple[str, ...], object] = {}

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, rank={self.rank})"

    def ways(self, axes: Sequence[str]) -> int:
        return math.prod(self.shape[a] for a in axes)

    def index(self, axes: Sequence[str]) -> int:
        """This rank's row-major index over ``axes`` (its block index along
        a dim sharded over them)."""
        i = 0
        for a in axes:
            i = i * self.shape[a] + self.coords[a]
        return i

    def _rank_of(self, coords: Dict[str, int]) -> int:
        return (coords["dp"] * self.shape["fsdp"] + coords["fsdp"]) * self.shape["tp"] + \
            coords["tp"]

    def ranks(self, axes: Sequence[str], coords: Optional[Dict[str, int]] = None) -> list:
        """The ranks that share ``coords`` (this rank's by default) on every
        axis outside ``axes``, in row-major order over ``axes``."""
        base = dict(coords or self.coords)
        out = []
        for flat in range(self.ways(axes)):
            c = dict(base)
            for a in reversed(axes):
                c[a] = flat % self.shape[a]
                flat //= self.shape[a]
            out.append(self._rank_of(c))
        return out

    def group(self, axes: Sequence[str]):
        """The process group of this rank along ``axes``."""
        axes = tuple(axes)
        if axes not in self._groups:
            if self.ways(axes) == self.size:
                self._groups[axes] = dist.group.WORLD
            else:
                others = [a for a in AXES if a not in axes]
                mine = None
                for flat in range(self.size // self.ways(axes)):
                    c = {a: 0 for a in AXES}
                    for a in reversed(others):
                        c[a] = flat % self.shape[a]
                        flat //= self.shape[a]
                    members = self.ranks(axes, c)
                    g = dist.new_group(members)
                    if self.rank in members:
                        mine = g
                self._groups[axes] = mine
        return self._groups[axes]


def _world_and_rank(world_size: Optional[int], rank: Optional[int]) -> Tuple[int, int]:
    if world_size is None:
        world_size = dist.get_world_size() if dist.is_initialized() else 1
    if rank is None:
        rank = dist.get_rank() if dist.is_initialized() else 0
    return world_size, rank


def create_mesh(dp: int = 1, fsdp: int = -1, tp: int = 1, *, world_size: Optional[int] = None,
                rank: Optional[int] = None) -> Mesh:
    """A (dp, fsdp, tp) mesh over the world (``sharding.py:28-41``); fsdp -1
    absorbs the remaining ranks. Raises when the sizes do not multiply to
    the world size, with the JAX function's message."""
    n, rank = _world_and_rank(world_size, rank)
    if fsdp == -1:
        if n % (dp * tp):
            raise ValueError(f"mesh {dp}x-1x{tp}: {n} devices do not divide by {dp * tp}")
        fsdp = n // (dp * tp)
    if dp * fsdp * tp != n:
        raise ValueError(f"mesh {dp}x{fsdp}x{tp} != {n} devices")
    return Mesh(dp, fsdp, tp, rank)


def create_hybrid_mesh(dp_dcn: int, fsdp_ici: int, tp: int = 1, *,
                       world_size: Optional[int] = None, rank: Optional[int] = None) -> Mesh:
    """The ZeRO++ hpZ layout (``sharding.py:43-61``): contiguous fsdp groups,
    dp across them. Launchers number ranks host by host, so with
    ``fsdp_ici`` = ranks per host the parameter gathers stay inside a host
    and only the gradient reduction over dp crosses hosts."""
    return create_mesh(dp_dcn, fsdp_ici, tp, world_size=world_size, rank=rank)


# (regex over the '/'-joined tree path) -> spec; stacked layers keep their
# leading L axis whole (``sharding.py:64-106``)
_PARAM_RULES: Sequence[Tuple[str, Spec]] = (
    # decoder
    (r".*embed_tokens$", ("fsdp", "tp")),
    (r".*layers/qkv_proj$", (None, "fsdp", "tp")),
    (r".*layers/o_proj$", (None, "tp", "fsdp")),
    (r".*layers/gate_up_proj$", (None, "fsdp", "tp")),
    (r".*layers/down_proj$", (None, "tp", "fsdp")),
    (r".*layers/(input|post_attention)_layernorm$", ()),
    (r".*final_layernorm$", ()),
    (r".*lm_head$", ("fsdp", "tp")),
    # qwen / llava decoders (one {kernel, bias} per projection)
    (r".*layers/(q_proj|k_proj|v_proj|gate_proj|up_proj)/kernel$", (None, "fsdp", "tp")),
    (r".*layers/(o_proj|down_proj)/kernel$", (None, "tp", "fsdp")),
    # qwen window-attention vision tower
    (r".*visual/patch_embed$", ("fsdp", None)),
    (r".*blocks/qkv/kernel$", (None, "fsdp", "tp")),
    (r".*blocks/proj/kernel$", (None, "tp", "fsdp")),
    (r".*blocks/mlp/(gate|up)/kernel$", (None, "fsdp", "tp")),
    (r".*blocks/mlp/down/kernel$", (None, "tp", "fsdp")),
    (r".*merger/fc[12]/kernel$", ("fsdp", "tp")),
    # llava projector
    (r".*vision/projector/fc[12]/kernel$", ("fsdp", "tp")),
    # clip tower
    (r".*clip/patch_proj$", ("fsdp", None)),
    (r".*clip/position_embedding$", ()),
    (r".*clip/class_embedding$", ()),
    (r".*clip/layers/attn/(q|k|v)/kernel$", (None, "fsdp", "tp")),
    (r".*clip/layers/attn/out/kernel$", (None, "tp", "fsdp")),
    (r".*clip/layers/mlp/fc1/kernel$", (None, "fsdp", "tp")),
    (r".*clip/layers/mlp/fc2/kernel$", (None, "tp", "fsdp")),
    # projector
    (r".*img_projection/fc1/kernel$", ("fsdp", "tp")),
    (r".*img_projection/fc2/kernel$", ("fsdp", "tp")),
    # lora: the big input dim of A over fsdp, B replicated
    (r".*lora.*/a$", (None, "fsdp", None)),
    (r".*lora.*/b$", ()),
    # reward heads / skipca
    (r".*(value_head|prompt_head)/kernel$", ()),
    (r".*W_[qkv]/kernel$", ("fsdp", "tp")),
)


def spec_for_path(path: str, leaf=None) -> Spec:
    """The first rule matching ``path``; a spec longer than the leaf's rank,
    and a path no rule matches, replicate (``sharding.py:73-80``)."""
    for pattern, spec in _PARAM_RULES:
        if re.match(pattern, path):
            if leaf is not None and len(spec) > getattr(leaf, "ndim", 99):
                return ()
            return spec
    return ()


def _is_qleaf(tree) -> bool:
    return is_quantized(tree) or is_w8a8(tree)


def _walk(fn, tree, path="", is_leaf=lambda t: False):
    """``fn(path, leaf)`` over a nested dict; ``None`` subtrees stay; a dict
    that ``is_leaf`` names is one leaf."""
    if tree is None:
        return None
    if isinstance(tree, dict) and not is_leaf(tree):
        return {k: _walk(fn, v, f"{path}/{k}" if path else str(k), is_leaf)
                for k, v in tree.items()}
    return fn(path, tree)


def param_specs(params) -> dict:
    """The tree of specs matching ``params`` (``sharding.py:95-99``)."""
    return _walk(spec_for_path, params)


def _divisible_spec(spec: Spec, leaf, mesh: Mesh) -> Spec:
    """Replicate any dim the mesh does not divide (``sharding.py:102-116``)."""
    if leaf is None or not hasattr(leaf, "shape"):
        return spec
    fixed = []
    for d, names in enumerate(spec):
        if names is None:
            fixed.append(None)
            continue
        group = names if isinstance(names, tuple) else (names,)
        fixed.append(names if leaf.shape[d] % mesh.ways(group) == 0 else None)
    return tuple(fixed)


# fused out axes split over tp, by path -> their ``tensor.fused_parts`` key
_FUSED: Sequence[Tuple[str, str]] = (
    (r".*layers/qkv_proj$", "qkv"),
    (r".*layers/gate_up_proj$", "gate_up"),
    (r".*blocks/qkv/kernel$", "vision_qkv"),
    (r".*layers/qkv_proj/kernel$", "qkv"),
    (r".*layers/gate_up_proj/kernel$", "gate_up"),
)
# the fused inference layout of the qwen / LLaVA decoders
# (``qwen25_vl.fuse_decoder_projections``): no rule places it; a quantized
# one is split over tp on its out columns, as the projections it fuses are
_FUSED_INFERENCE = r".*layers/(qkv_proj|gate_up_proj)/kernel$"


def _unsplit_parts(t: torch.Tensor, parts: Sequence[int], size: int, dim: int) -> torch.Tensor:
    """The inverse of ``slice_parts`` over all ``size`` ranks: ``t`` holds
    the ranks' blocks in order along ``dim``; each part's slices go back
    together."""
    blocks = [b.split([p // size for p in parts], dim) for b in t.chunk(size, dim)]
    return torch.cat([torch.cat([b[j] for b in blocks], dim) for j in range(len(parts))], dim)


class Sharded:
    """This rank's block of a leaf split along ``dims`` ({axis: dim}, "fsdp"
    and / or "tp"); ``parts``, for a fused out axis split over tp, its parts'
    full widths. The optimizer's tree functions map over ``local`` and keep
    the wrapper (``train/optim.tree_map``), so gradients and Adam's moments
    stay as sharded as their leaf."""

    __slots__ = ("local", "mesh", "dims", "parts")

    def __init__(self, local: torch.Tensor, mesh: Mesh, dims: Dict[str, int],
                 parts: Optional[Sequence[int]] = None):
        self.local, self.mesh, self.dims, self.parts = local, mesh, dims, parts

    def __repr__(self) -> str:
        return f"Sharded({tuple(self.local.shape)}, {self.dims}, {self.mesh})"

    @property
    def axes(self) -> Tuple[str, ...]:
        """The mesh axes this leaf is split over."""
        return tuple(a for a in ("fsdp", "tp") if a in self.dims)

    def with_local(self, local: torch.Tensor) -> "Sharded":
        return Sharded(local, self.mesh, self.dims, self.parts)

    def _fsdp(self, x: torch.Tensor, lead: int = 0) -> torch.Tensor:
        if "fsdp" not in self.dims:
            return x
        return gather_shard(x, self.dims["fsdp"] - lead, self.mesh.group(("fsdp",)))

    def full(self) -> torch.Tensor:
        """The whole leaf in the JAX layout (fused parts back in order),
        gathered over both axes under autograd; a K-major block (W8A8 codes)
        gives a K-major leaf."""
        x = self._fsdp(self.local)
        if "tp" not in self.dims:
            return x
        d = self.dims["tp"]
        x = gather_whole(x, d, self.mesh.group(("tp",)))
        x = _unsplit_parts(x, self.parts, self.mesh.shape["tp"], d) if self.parts else x
        k_major_block = self.local.dim() >= 2 and not self.local.is_contiguous() \
            and self.local.mT.is_contiguous()
        return k_major(x) if k_major_block else x

    def layer(self, i: int) -> torch.Tensor:
        """Layer ``i`` of a stacked leaf, gathered over fsdp under autograd;
        its tp block kept for the split projection that uses it."""
        return self._fsdp(self.local[i], lead=1)


def _axis_dims(spec: Spec, mesh: Mesh) -> Dict[str, int]:
    """{axis: dim} for each axis of ``spec`` that splits a dim (size > 1)."""
    out = {}
    for d, names in enumerate(spec):
        for a in (names if isinstance(names, tuple) else (names,)):
            if a is not None and mesh.shape[a] > 1:
                out[a] = d
    return out


def _fused_key(path: str) -> Optional[str]:
    return next((k for pattern, k in _FUSED if re.match(pattern, path)), None)


def _block(t: torch.Tensor, dims: Dict[str, int], mesh: Mesh,
           parts: Optional[Sequence[int]] = None) -> torch.Tensor:
    """This rank's block of the whole ``t``: a contiguous slice along the
    fsdp dim, and along the tp dim each fused part's own slice."""
    if "fsdp" in dims:
        n = t.shape[dims["fsdp"]] // mesh.shape["fsdp"]
        t = t.narrow(dims["fsdp"], mesh.index(("fsdp",)) * n, n)
    if "tp" in dims:
        d = dims["tp"]
        t = slice_parts(t, parts or (t.shape[d],), mesh.shape["tp"], mesh.coords["tp"], d)
    return t


def _quant_kinds(tree) -> set:
    """The packed 4-bit schemes among ``tree``'s quantized leaves."""
    if not isinstance(tree, dict):
        return set()
    if _is_qleaf(tree):
        return {k[len("qvalues_"):] for k in tree if k in ("qvalues_nf4", "qvalues_i4")}
    return set().union(*map(_quant_kinds, tree.values()))


def _quant_blocks(path: str, qd: dict, mesh: Mesh, parts: dict) -> dict:
    """This tp rank's block of the quantized leaf ``qd`` at ``path``: split on
    the tp dim of its float kernel's rule (or of the fused inference layout),
    each split entry a ``Sharded`` over tp; whole where tp is 1 or no rule
    splits it over tp."""
    if mesh.shape["tp"] == 1:
        return qd
    meta = torch.empty(logical_shape(qd), device="meta")
    spec = (None, None, "tp") if re.match(_FUSED_INFERENCE, path) and meta.ndim == 3 \
        else spec_for_path(path, meta)
    d = _axis_dims(_divisible_spec(spec, meta, mesh), mesh).get("tp")
    if d is None:
        return qd
    rows = d == meta.ndim - 2
    p = None if rows else parts.get(_fused_key(path))
    block = tp_block(qd, rows, p or (meta.shape[d],), mesh.shape["tp"], mesh.coords["tp"])
    return {k: v if dim is None else Sharded(v, mesh, {"tp": v.dim() + dim}, p)
            for (k, v), dim in zip(block.items(), tp_block_dims(qd, rows).values())}


def shard_params(tree, mesh: Mesh, cfg=None):
    """Each leaf whose (divisible) spec names "fsdp" or "tp" becomes a
    ``Sharded`` holding a contiguous copy of this rank's block; every other
    leaf stays as it is (``sharding.py:126-152``). With fsdp and tp 1 the
    tree comes back unchanged. A tp mesh needs the family's config ``cfg``:
    tp must divide its heads and MLP widths, which also place the fused
    blocks, and a 4-bit decoder's row-split widths. A quantized leaf keeps
    its tp block (``_quant_blocks``)."""
    tp = mesh.shape["tp"]
    parts = {}
    if tp > 1:
        if cfg is None:
            raise ValueError("a tp mesh needs the model config: its widths place the blocks")
        check_tp(cfg, tp)
        for kind in sorted(_quant_kinds(tree)):
            check_tp(cfg, tp, {"i4": "int4"}.get(kind, kind))
        parts = fused_parts(cfg)

    def one(path, leaf):
        if _is_qleaf(leaf):
            return _quant_blocks(path, leaf, mesh, parts)
        if not isinstance(leaf, torch.Tensor):
            return leaf
        dims = _axis_dims(_divisible_spec(spec_for_path(path, leaf), leaf, mesh), mesh)
        if not dims:
            return leaf
        p = parts.get(_fused_key(path)) if "tp" in dims else None
        block = _block(leaf.detach(), dims, mesh, p).contiguous().clone()
        return Sharded(block.requires_grad_(leaf.requires_grad), mesh, dims, p)

    return _walk(one, tree, is_leaf=_is_qleaf)


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, v) for v in tree)
    return fn(tree)


def gather_unstacked(tree):
    """Every ``Sharded`` leaf gathered whole under autograd (over fsdp and
    tp), except inside stacked-layer subtrees ("layers", "blocks"), which the
    models gather a layer at a time."""
    if isinstance(tree, dict):
        return {k: v if k in ("layers", "blocks") else gather_unstacked(v)
                for k, v in tree.items()}
    return tree.full() if isinstance(tree, Sharded) else tree


@torch.no_grad()
def gather_tree(tree):
    """The whole tree on every rank, every ``Sharded`` leaf gathered in the
    JAX layout, fused parts back in order (saving); any other leaf, tensor or
    not, as it is."""
    return _map(lambda x: x.full() if isinstance(x, Sharded) else x, tree)


def reshard_like(full, like):
    """``full`` (a whole tree, e.g. a loaded checkpoint) sharded as ``like``
    is: each leaf where ``like`` holds a ``Sharded`` keeps this rank's block."""
    if isinstance(like, dict):
        return {k: reshard_like(full[k], v) for k, v in like.items()}
    if isinstance(like, Sharded):
        block = _block(full, like.dims, like.mesh, like.parts)
        return like.with_local(block.contiguous().clone())
    return full


def _rows(x, mesh: Mesh, name: Optional[str] = None):
    if not isinstance(x, torch.Tensor) or x.ndim == 0:
        return x
    # M-RoPE position ids are (3, B, S): the batch axis is axis 1
    axis = 1 if name == "position_ids" and x.ndim >= 2 else 0
    n = mesh.ways(DATA)
    if x.shape[axis] % n:
        raise ValueError(f"batch of {x.shape[axis]} rows does not split over {n} data ranks")
    b = x.shape[axis] // n
    return x.narrow(axis, mesh.index(DATA) * b, b)


def shard_batch(batch, mesh: Mesh):
    """This rank's rows of a global batch (``sharding.py:155-201``): a
    ``RewardBatch`` field by field (the resize tables' leaves too), a tensor
    on axis 0, ``None`` as is."""
    if batch is None:
        return None
    if hasattr(batch, "_fields"):  # RewardBatch
        return type(batch)(**{
            name: _map(lambda x, a=name: _rows(x, mesh, a), v)
            for name, v in zip(batch._fields, batch)})
    return _rows(batch, mesh)
