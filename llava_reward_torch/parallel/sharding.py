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
heads, kv heads and MLP widths must divide by tp, and quantized leaves are
refused (their placement under tp is ROADMAP A9).

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


def _walk(fn, tree, path=""):
    """``fn(path, leaf)`` over a nested dict; ``None`` subtrees stay."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _walk(fn, v, f"{path}/{k}" if path else str(k)) for k, v in tree.items()}
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
)


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
        gathered over both axes under autograd."""
        x = self._fsdp(self.local)
        if "tp" not in self.dims:
            return x
        d = self.dims["tp"]
        x = gather_whole(x, d, self.mesh.group(("tp",)))
        return _unsplit_parts(x, self.parts, self.mesh.shape["tp"], d) if self.parts else x

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


def shard_params(tree, mesh: Mesh, cfg=None):
    """Each leaf whose (divisible) spec names "fsdp" or "tp" becomes a
    ``Sharded`` holding a contiguous copy of this rank's block; every other
    leaf stays as it is (``sharding.py:126-152``). With fsdp and tp 1 the
    tree comes back unchanged. A tp mesh needs the family's config ``cfg``:
    tp must divide its heads and MLP widths, which also place the fused
    blocks; a quantized leaf under tp is refused (ROADMAP A9)."""
    tp = mesh.shape["tp"]
    parts = {}
    if tp > 1:
        if cfg is None:
            raise ValueError("a tp mesh needs the model config: its widths place the blocks")
        check_tp(cfg, tp)
        parts = fused_parts(cfg)

    def one(path, leaf):
        if tp > 1 and path.rsplit("/", 1)[-1].startswith("qvalues"):
            raise NotImplementedError(
                f"{path}: a quantized frozen decoder under tp {tp} is ROADMAP A9 (the JAX "
                "package keeps those leaves whole on every tp rank)")
        if not isinstance(leaf, torch.Tensor):
            return leaf
        dims = _axis_dims(_divisible_spec(spec_for_path(path, leaf), leaf, mesh), mesh)
        if not dims:
            return leaf
        p = parts.get(_fused_key(path)) if "tp" in dims else None
        block = _block(leaf.detach(), dims, mesh, p).contiguous().clone()
        return Sharded(block.requires_grad_(leaf.requires_grad), mesh, dims, p)

    return _walk(one, tree)


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
