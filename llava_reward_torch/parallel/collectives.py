"""The collectives the mesh needs, over ``torch.distributed`` process groups.

Transport follows the group's backend. NCCL takes card tensors as they are.
Gloo (the CPU, or several ranks sharing one card, which NCCL refuses) takes
host tensors: card tensors are staged through host memory explicitly
(``.cpu()``, the collective, ``.to(device)``), and the reduce-scatter is an
all-reduce of which each rank keeps its block (``reduce_scatter_tensor`` is
not in every gloo build). A group of one rank returns its input.

Gathers and scatters work along any dim through a (world, ...) buffer and a
``movedim``, so the result is contiguous whatever the dim: rank r's block
sits at [r * n, (r + 1) * n) of ``dim``, the layout of a JAX
``NamedSharding`` over that axis.

Under autograd (the tensor-parallel ones Megatron-style, over the tp group):

  gather_shard  all-gather; backward reduce-scatters (fsdp: each rank's rows
                take the group's summed gradient)
  enter_tp      identity; backward all-reduces (the input of a column-split
                projection, a replicated leaf a rank uses in part)
  leave_tp      all-reduce; backward identity (a row-split projection's
                partial sums)
  gather_whole  all-gather; backward takes this rank's block unsummed (a
                tp-split leaf used whole: the tp peers hold the same rows
                and compute the same gradient)

Every rank of a group issues its collectives in the same order, the
recompute of a checkpointed layer included, since all run the same graph.
"""

from __future__ import annotations

from typing import Any, List

import torch
import torch.distributed as dist


def _staged(group) -> bool:
    return dist.get_backend(group) != "nccl"


def all_gather(t: torch.Tensor, dim: int, group) -> torch.Tensor:
    """Every rank's block of ``t`` concatenated along ``dim`` in group order."""
    w = dist.get_world_size(group)
    if w == 1:
        return t
    x = t.detach().contiguous()
    if _staged(group):
        x = x.cpu()
        parts = [torch.empty_like(x) for _ in range(w)]
        dist.all_gather(parts, x, group=group)
        buf = torch.stack(parts).to(t.device)
    else:
        buf = x.new_empty((w, *x.shape))
        dist.all_gather_into_tensor(buf, x, group=group)
    return buf.movedim(0, dim).flatten(dim, dim + 1).contiguous()


def reduce_scatter(t: torch.Tensor, dim: int, group) -> torch.Tensor:
    """The sum over the group of ``t``, of which this rank keeps its block
    along ``dim`` (the inverse layout of ``all_gather``)."""
    w = dist.get_world_size(group)
    if w == 1:
        return t
    x = t.detach().unflatten(dim, (w, t.shape[dim] // w)).movedim(dim, 0).contiguous()
    if _staged(group):
        y = x.cpu()
        dist.all_reduce(y, group=group)
        return y[dist.get_rank(group)].to(t.device)
    out = x.new_empty(x.shape[1:])
    dist.reduce_scatter_tensor(out, x, group=group)
    return out


def all_reduce(t: torch.Tensor, group, op=dist.ReduceOp.SUM) -> torch.Tensor:
    """``t`` reduced by ``op`` (the sum by default) over the group, as a new
    tensor."""
    if dist.get_world_size(group) == 1:
        return t
    y = t.detach().clone()
    if _staged(group):
        y = y.cpu()
        dist.all_reduce(y, op=op, group=group)
        return y.to(t.device)
    dist.all_reduce(y, op=op, group=group)
    return y


def all_reduce_max(t: torch.Tensor, group) -> torch.Tensor:
    """The elementwise max of ``t`` over the group, detached (a row-split
    W8A8 projection's (M, 1) fp32 row amax: its tp-global value; the codes
    taken on it carry no gradient)."""
    return all_reduce(t.detach(), group, dist.ReduceOp.MAX)


def all_gather_list(values: List[Any], group) -> List[Any]:
    """Every rank's list of Python values, concatenated in group order
    (evaluation's probabilities, rewards and labels)."""
    w = dist.get_world_size(group)
    if w == 1:
        return list(values)
    out: List[Any] = [None] * w
    dist.all_gather_object(out, list(values), group=group)
    return [v for part in out for v in part]


def barrier(group=None) -> None:
    if dist.is_initialized() and dist.get_world_size(group) > 1:
        dist.barrier(group=group)


class _GatherShard(torch.autograd.Function):
    """All-gather of a shard along ``dim``; the backward reduce-scatters the
    gradient, so each rank's shard receives the group's summed gradient."""

    @staticmethod
    def forward(ctx, local: torch.Tensor, dim: int, group) -> torch.Tensor:
        ctx.dim, ctx.group = dim, group
        return all_gather(local, dim, group)

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        return reduce_scatter(g, ctx.dim, ctx.group), None, None


def gather_shard(local: torch.Tensor, dim: int, group) -> torch.Tensor:
    """The whole tensor from each rank's block along ``dim``, under autograd."""
    return _GatherShard.apply(local, dim, group)


class _EnterTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x: torch.Tensor, group) -> torch.Tensor:
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        return all_reduce(g, ctx.group), None


class _LeaveTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x: torch.Tensor, group) -> torch.Tensor:
        return all_reduce(x, group)

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        return g, None


class _GatherWhole(torch.autograd.Function):
    @staticmethod
    def forward(ctx, local: torch.Tensor, dim: int, group) -> torch.Tensor:
        ctx.dim, ctx.n, ctx.i = dim, local.shape[dim], dist.get_rank(group)
        return all_gather(local, dim, group)

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        return g.narrow(ctx.dim, ctx.i * ctx.n, ctx.n).contiguous(), None, None


def enter_tp(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` as it is; its gradient summed over ``group`` (Megatron's copy
    into the tensor-parallel region)."""
    return _EnterTP.apply(x, group)


def leave_tp(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` summed over ``group``; its gradient passed as it is (Megatron's
    reduce from the tensor-parallel region)."""
    return _LeaveTP.apply(x, group)


def gather_whole(local: torch.Tensor, dim: int, group) -> torch.Tensor:
    """The whole tensor from each rank's block along ``dim``; the backward
    keeps this rank's block of the gradient without summing it."""
    return _GatherWhole.apply(local, dim, group)
