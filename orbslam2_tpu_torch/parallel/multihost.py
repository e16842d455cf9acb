"""Multi-process execution over `torch.distributed`.

Port of orbslam2_tpu/parallel/multihost.py. The JAX package runs one
process per host (`jax.distributed.initialize`), forms a global mesh over
every chip and feeds it the same `shard_map` programs as in one process.
Here each process is one rank of a `torch.distributed` process group and
holds one shard of `global_mesh()`; the sharded solvers
(`dist_ba.make_distributed_ba_pm`, `dist_posegraph.make_distributed_posegraph`)
run unchanged on it, with `all_reduce` for their sums
(`mesh.GroupReducer`).

Backend: NCCL when every rank has a card of its own; gloo on the CPU and
when ranks share a card (NCCL refuses two ranks on one device), with the
collectives on host copies. With two ranks a sum of two partials has the
same bits in either order, so a 2-rank solve equals the in-process 2-shard
mesh's bit for bit.

    multihost.initialize("localhost:29500", 2, rank)
    mesh = multihost.global_mesh()
    res = dist_ba.make_distributed_ba_pm(mesh, cam)(multihost.put_global(prob, dist_ba.PM_SPECS, mesh))
    poses = multihost.fetch_replicated(res.poses)
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from .mesh import Mesh, put_global  # noqa: F401 -- put_global is this module's API too

#: the device this process brought to the process group (`initialize`),
#: process state like the group itself
_local_device: Optional[torch.device] = None


def initialize(coordinator: str, num_processes: int, process_id: int,
               local_device_ids: Optional[Sequence[int]] = None) -> torch.device:
    """`torch.distributed.init_process_group` over `tcp://<coordinator>`
    (host:port); call once per process before any collective. This rank's
    device: the CPU without CUDA, else card `local_device_ids[0]` (default:
    the rank, modulo the cards visible). Returns it."""
    global _local_device
    n_cards = torch.cuda.device_count()
    if n_cards == 0:
        device, backend = torch.device("cpu"), "gloo"
    else:
        idx = local_device_ids[0] if local_device_ids else process_id % n_cards
        device = torch.device("cuda", idx)
        torch.cuda.set_device(device)
        backend = "nccl" if n_cards >= num_processes else "gloo"
    dist.init_process_group(backend, init_method=f"tcp://{coordinator}", world_size=num_processes,
                            rank=process_id)
    _local_device = device
    return device


def global_mesh() -> Mesh:
    """A 1-D mesh with one shard per rank of the default process group, in
    rank order; this process holds shard `rank`."""
    if _local_device is None:
        raise RuntimeError("multihost.initialize() first")
    names: list = [None] * dist.get_world_size()
    dist.all_gather_object(names, str(_local_device))
    return Mesh(names, process_group=dist.group.WORLD, rank=dist.get_rank())


def fetch_replicated(x: torch.Tensor) -> np.ndarray:
    """A replicated result (every shard holds the same) as host numpy."""
    return x.detach().cpu().numpy()
