"""Process-group initialisation; counterpart of
cvpce_tpu/parallel/multihost.py.

One process drives one device. `initialize_multihost()` joins this
process to a `torch.distributed` process group: NCCL for a card, gloo
for the CPU, from `torchrun`'s environment (MASTER_ADDR, MASTER_PORT,
WORLD_SIZE, RANK, LOCAL_RANK) or explicit arguments, then runs one
all-reduce of ones as the JAX package's warm-up check does. Per-process
input sharding uses `host_shard_info()` with data/loader.py's
`shard_index` / `num_shards` (DistributedSampler's place).
"""
from __future__ import annotations

import datetime
import os
from typing import Optional, Tuple

import torch
import torch.distributed as dist

from ..utils import resolve_device

# a rank that never reaches a collective fails the others in this time
DEFAULT_TIMEOUT = datetime.timedelta(minutes=5)


def initialize_multihost(coordinator_address: Optional[str] = None,
                         num_processes: Optional[int] = None,
                         process_id: Optional[int] = None,
                         local_rank: Optional[int] = None,
                         backend: Optional[str] = None,
                         device="cuda",
                         timeout: datetime.timedelta = DEFAULT_TIMEOUT
                         ) -> None:
    """Join this process to the default process group.

    `coordinator_address` is `tcp://host:port` (default: MASTER_ADDR and
    MASTER_PORT), `num_processes` the world size (WORLD_SIZE),
    `process_id` this rank (RANK) and `local_rank` its card on this host
    (LOCAL_RANK, default 0); explicit arguments win over the
    environment. A no-op when no address is given and the world size is
    unset or 1; with an address it initialises even at world size 1.

    `backend` defaults to NCCL for `device="cuda"` and gloo for
    `device="cpu"`. With a card, this process takes `cuda:local_rank` as
    its current device. Nothing is retried or replaced: a failed
    initialisation or warm-up raises."""
    if coordinator_address is None and "MASTER_ADDR" in os.environ:
        coordinator_address = (f"tcp://{os.environ['MASTER_ADDR']}:"
                               f"{os.environ['MASTER_PORT']}")
    if num_processes is None and "WORLD_SIZE" in os.environ:
        num_processes = int(os.environ["WORLD_SIZE"])
    if process_id is None and "RANK" in os.environ:
        process_id = int(os.environ["RANK"])
    if local_rank is None:
        local_rank = int(os.environ.get("LOCAL_RANK", 0))
    if coordinator_address is None and num_processes in (None, 1):
        return  # one process
    if coordinator_address is None or num_processes is None \
            or process_id is None:
        raise ValueError(
            "a process group needs an address, a world size and a rank: "
            f"got {coordinator_address!r}, {num_processes!r}, "
            f"{process_id!r}")
    dev = resolve_device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(local_rank)
        dev = torch.device("cuda", local_rank)
    dist.init_process_group(
        backend or ("nccl" if dev.type == "cuda" else "gloo"),
        init_method=coordinator_address, world_size=num_processes,
        rank=process_id, timeout=timeout)
    _warmup_collectives(dev)


def _warmup_collectives(device: torch.device) -> None:
    """One all-reduce of ones right after the rendezvous: it sets up the
    communicator while every rank has just been released together, and
    fails fast where the group is inconsistent (JAX's warm-up check)."""
    ones = torch.ones(1, device=device)
    dist.all_reduce(ones)
    expected = float(dist.get_world_size())
    total = float(ones.item())
    if total != expected:
        raise RuntimeError(
            f"warm-up all-reduce returned {total}, expected {expected}: "
            "the process group is inconsistent")


def host_shard_info() -> Tuple[int, int]:
    """(shard_index, num_shards) for per-process data sharding: (rank,
    world size), or (0, 1) without a process group."""
    if not dist.is_initialized():
        return 0, 1
    return dist.get_rank(), dist.get_world_size()
