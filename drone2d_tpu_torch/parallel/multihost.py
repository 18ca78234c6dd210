"""Multi-process training setup: one process a device, `torch.distributed`.

Counterpart of `drone2d_tpu/parallel/multihost.py`.  JAX runs one program a
host over a mesh of every device of every host; here each process drives
one device (one rank a card), and the ranks of all hosts form one process
group.  The only process-specific work is starting the group and giving
each rank its own env slice, which `parallel/mesh.py::shard_init` does by
rank.

Usage (the same script on every process, e.g. under torchrun):

    from drone2d_tpu_torch.parallel import make_group, shard_init, shard_update
    group, device = make_group()             # reads torchrun's variables
    learner = PPOLearner(env_cfg, ppo_cfg, num_envs=GLOBAL_ENVS, device=device)
    state = shard_init(group, learner, seed) # the same seed on every rank
    update = shard_update(group, learner)

Checkpoints: the weights, the optimizer and the parent generator are
replicated, so rank 0 alone writes them (`train.py`).
"""

from __future__ import annotations

import dataclasses
import os
from datetime import timedelta
from typing import Optional

import torch
import torch.distributed as dist

# how long a collective or the rendezvous waits for the other ranks
TIMEOUT = timedelta(minutes=10)


@dataclasses.dataclass(frozen=True)
class HostInfo:
    process_index: int
    process_count: int
    local_device_count: int   # devices this host's processes drive, one a rank
    global_device_count: int  # devices of the whole group, one a rank

    @property
    def is_coordinator(self) -> bool:
        return self.process_index == 0


def default_backend(device) -> str:
    """NCCL for a CUDA device, gloo for the CPU."""
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def launched() -> bool:
    """True when a launcher (torchrun) started this process as one rank of
    a group: it sets WORLD_SIZE and RANK."""
    return "WORLD_SIZE" in os.environ and "RANK" in os.environ


def init_distributed(
    backend: Optional[str] = None,
    init_method: Optional[str] = None,
    world_size: Optional[int] = None,
    rank: Optional[int] = None,
) -> HostInfo:
    """Start the default process group when this process is one rank of
    several, or when the caller gives the group explicitly.

    Under torchrun the world size and rank come from WORLD_SIZE and RANK,
    and the rendezvous from MASTER_ADDR / MASTER_PORT (`env://`).  A lone
    process (no argument, no such variable) starts nothing.  `backend`
    defaults to NCCL when CUDA is available and gloo otherwise; it is never
    swapped after a failure: a group that cannot start raises.  A group
    already started is kept as it is."""
    if not dist.is_initialized():
        explicit = init_method is not None or world_size is not None
        if explicit or launched():
            if world_size is None:
                world_size = int(os.environ["WORLD_SIZE"])
            if rank is None:
                rank = int(os.environ.get("RANK", "0"))
            if init_method is None:
                if "MASTER_ADDR" not in os.environ:
                    raise ValueError("a group needs init_method or MASTER_ADDR/MASTER_PORT")
                init_method = "env://"
            if backend is None:
                backend = "nccl" if torch.cuda.is_available() else "gloo"
            dist.init_process_group(backend, init_method=init_method, world_size=world_size,
                                    rank=rank, timeout=TIMEOUT)
    return host_info()


def host_info() -> HostInfo:
    """This process's place in the group (rank 0 of 1 when none started).
    Each rank drives one device, so the group's devices are its ranks, and
    this host's are the ranks torchrun started here (LOCAL_WORLD_SIZE)."""
    if not dist.is_initialized():
        return HostInfo(0, 1, 1, 1)
    world = dist.get_world_size()
    return HostInfo(
        process_index=dist.get_rank(),
        process_count=world,
        local_device_count=int(os.environ.get("LOCAL_WORLD_SIZE", world)),
        global_device_count=world,
    )
