"""Multi-process entry points on `torch.distributed` (the JAX package's
`parallel/distributed.py`).

`initialize()` forms the process group from explicit arguments or from
torchrun's environment, one rank per process: NCCL with each rank bound to
its own GPU, or gloo for ranks on the CPU. `global_render_mesh()` is the
flat ("data",) mesh over every rank, for
`integrator/regen.render_regen_sharded`.

NCCL wants one rank per GPU: two ranks on one card fail with a duplicate-GPU
error, so a machine with one card runs a one-rank group. Several ranks run
on the CPU over gloo (the tests do so with four).

Nothing falls back. A group that fails to form, NCCL without CUDA, more
ranks than visible GPUs, and a collective past the group's `timeout` all
raise; a run never goes on with one rank or on another backend.
"""

from __future__ import annotations

import datetime
import os
from typing import Optional

import torch
import torch.distributed as dist

# How long a collective, or the group's forming, may wait on a peer before
# the run fails instead of hanging.
TIMEOUT_S = 600.0


def cuda_device_for(local_rank: int, local_world_size: int,
                    visible: int) -> torch.device:
    """The GPU of a rank: cuda:local_rank. Raises ValueError where the ranks
    on this host outnumber its visible GPUs (NCCL takes one GPU a rank)."""
    if local_world_size > visible or not 0 <= local_rank < visible:
        raise ValueError(
            f"{local_world_size} ranks on this host (local rank {local_rank})"
            f" but {visible} visible GPU(s): NCCL runs one rank per GPU")
    return torch.device("cuda", local_rank)


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None, device=None,
               timeout: float = TIMEOUT_S) -> bool:
    """Form the default process group. Explicit arguments win; otherwise
    torchrun's environment (MASTER_ADDR/MASTER_PORT, WORLD_SIZE, RANK,
    LOCAL_RANK, LOCAL_WORLD_SIZE) is read. With neither a coordinator
    address nor MASTER_ADDR, returns False: single-process mode, as the
    JAX package's `initialize` does.

    `coordinator_address` is an init method URL (`tcp://host:port`,
    `file:///path`) or `host:port`. `device` picks the backend: CUDA (the
    default) runs NCCL with the rank bound to cuda:LOCAL_RANK (LOCAL_RANK
    defaults to the rank), the CPU runs gloo. `timeout` (seconds) bounds
    the forming and every collective. Returns True once the group is up."""
    from go_raytracer_tpu_torch.integrator import regen as regen_mod

    env = os.environ
    addr = coordinator_address
    if addr is None and "MASTER_ADDR" in env:
        addr = f"{env['MASTER_ADDR']}:{env.get('MASTER_PORT', '29500')}"
    if addr is None:
        return False
    if "://" not in addr:
        addr = "tcp://" + addr
    world = int(num_processes if num_processes is not None
                else env["WORLD_SIZE"])
    rank = int(process_id if process_id is not None else env["RANK"])
    if not 0 <= rank < world:
        raise ValueError(f"rank {rank} outside a world of {world}")
    if dist.is_initialized():
        raise RuntimeError("a default process group is already initialized")
    device = regen_mod.resolve_device(device)
    kw = {}
    if device.type == "cuda":
        local = int(env.get("LOCAL_RANK", rank))
        local_world = int(env.get("LOCAL_WORLD_SIZE", world))
        device = cuda_device_for(local, local_world,
                                 torch.cuda.device_count())
        torch.cuda.set_device(device)
        backend = "nccl"
        kw["device_id"] = device
    elif device.type == "cpu":
        backend = "gloo"
    else:
        raise ValueError(f"no process-group backend for device {device}")
    dist.init_process_group(
        backend, init_method=addr, world_size=world, rank=rank,
        timeout=datetime.timedelta(seconds=timeout), **kw)
    return True


def global_render_mesh():
    """The flat ("data",) mesh over every rank of the group, for
    `integrator/regen.render_regen_sharded`."""
    from go_raytracer_tpu_torch.parallel import mesh as pmesh

    return pmesh.make_mesh(dist.get_world_size(), axes=("data",))
