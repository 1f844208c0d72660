"""Distributed start-up and the mesh from the train flags (the port's copy
of ``llava_reward_tpu/core/mesh.py``), over ``torch.distributed``: one
process per device.

The DeepSpeed flags map onto the mesh as in the JAX package:

  --zero_stage 0     -> dp only (parameters replicated)
  --zero_stage 1/2/3 -> the fsdp axis (parameters and optimizer state sharded)
  --zpg > 1          -> the hybrid mesh: fsdp within a group of zpg ranks,
                        dp across groups (ZeRO++ hpZ)

The backend follows the layout: NCCL when every rank of a host has a card of
its own, gloo when ranks outnumber a host's cards (NCCL refuses two ranks on
one device) and on the CPU. ``parallel/collectives.py`` stages card tensors
through host memory for gloo.
"""

from __future__ import annotations

import datetime
import os
from typing import Optional

import torch
import torch.distributed as dist

from ..parallel.sharding import Mesh, create_hybrid_mesh, create_mesh
from .logging import init_logger

logger = init_logger(__name__)

TIMEOUT_S = 600  # a dead rank fails the others after this long instead of hanging them


def _env_int(*names: str) -> Optional[int]:
    for n in names:
        if os.environ.get(n):
            return int(os.environ[n])
    return None


def setup_distributed(device: str = "cuda") -> None:
    """Join the process group; a no-op for one process launched alone
    (``mesh.py:24-46``). The address, world size and rank come from the JAX
    package's ``LRT_COORDINATOR`` (host:port), ``LRT_NUM_PROCESSES`` and
    ``LRT_PROCESS_ID``, else from torchrun's ``MASTER_ADDR`` /
    ``MASTER_PORT``, ``WORLD_SIZE`` and ``RANK``; ``LOCAL_RANK`` /
    ``LOCAL_WORLD_SIZE`` (torchrun's) pick the card and the backend,
    defaulting to the rank and the world size (one host). On the card the
    process takes card ``LOCAL_RANK % device_count`` before the group
    starts."""
    if dist.is_initialized():
        return
    coordinator_address = os.environ.get("LRT_COORDINATOR")
    if coordinator_address is None and os.environ.get("MASTER_ADDR"):
        coordinator_address = (f"{os.environ['MASTER_ADDR']}:"
                               f"{os.environ.get('MASTER_PORT', '29500')}")
    num_processes = _env_int("LRT_NUM_PROCESSES", "WORLD_SIZE")
    process_id = _env_int("LRT_PROCESS_ID", "RANK")
    if not ((num_processes or 1) > 1 or coordinator_address):
        return
    if coordinator_address is None:
        raise ValueError(f"{num_processes} processes but no coordinator address "
                         "(LRT_COORDINATOR, or MASTER_ADDR and MASTER_PORT)")
    world = num_processes or 1
    rank = process_id or 0
    local = _env_int("LOCAL_RANK")
    local = rank if local is None else local
    per_host = _env_int("LOCAL_WORLD_SIZE") or world
    backend = "gloo"
    if torch.device(device).type == "cuda":
        n_cards = torch.cuda.device_count()
        torch.cuda.set_device(local % n_cards)
        if per_host <= n_cards:
            backend = "nccl"
    elif per_host > 1 and not os.environ.get("OMP_NUM_THREADS"):
        # ranks sharing a host's cores each take their share (torchrun's
        # default): oversubscribed threads slow gloo's ranks several-fold
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // per_host))
    dist.init_process_group(backend, init_method=f"tcp://{coordinator_address}",
                            world_size=world, rank=rank,
                            timeout=datetime.timedelta(seconds=TIMEOUT_S))
    card = f", card {torch.cuda.current_device()}" if torch.device(device).type == "cuda" else ""
    logger.info("rank %d of %d joined over %s (%d ranks on this host%s)", rank, world, backend,
                per_host, card)


def backend() -> Optional[str]:
    """The process group's backend, None for one process alone."""
    return dist.get_backend() if dist.is_initialized() else None


def world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def local_rank() -> int:
    """This process's index in the world (``jax.process_index()``, as the
    JAX function of this name returns)."""
    return dist.get_rank() if dist.is_initialized() else 0


def is_rank_0() -> bool:
    return local_rank() == 0


def mesh_from_args(args, world: Optional[int] = None, rank: Optional[int] = None) -> Mesh:
    """The mesh from the train flags (``mesh.py:49-67``), n the world size."""
    n = world_size() if world is None else world
    rank = local_rank() if rank is None else rank
    tp = getattr(args, "mesh_tp", 1)
    if getattr(args, "zero_stage", 2) == 0:
        return create_mesh(dp=n, fsdp=1, tp=tp, world_size=n, rank=rank)
    zpg = getattr(args, "zpg", 1)
    if zpg and zpg > 1 and n % zpg == 0 and n > zpg:
        return create_hybrid_mesh(dp_dcn=n // zpg, fsdp_ici=zpg, tp=tp, world_size=n, rank=rank)
    return create_mesh(dp=getattr(args, "mesh_dp", 1), fsdp=getattr(args, "mesh_fsdp", -1),
                       tp=tp, world_size=n, rank=rank)
