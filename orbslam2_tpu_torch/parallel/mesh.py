"""Device meshes for the whole-map passes (the global BA, the essential graph).

Port of orbslam2_tpu/parallel/mesh.py. The reference has no distributed
backend (its parallelism is 4 pthreads in one process); the JAX package
shards its whole-map solvers over a `jax.sharding.Mesh` with `shard_map`
and lets every cross-shard sum ride a `psum`. Here a `Mesh` is an ordered
tuple of shard devices along one axis, `EDGE_AXIS`:

  * in one process, `make_mesh(n)` takes the first n visible CUDA devices
    (as JAX takes the first n devices), and `Mesh([dev] * n)` puts n
    shards on one device: the CPU tests' stand-in for JAX's 8 virtual CPU
    devices, and the card's smoke run on one card. `Mesh.run` runs one
    thread per shard, and the threads take turns; at each cross-shard sum
    the partials meet, are added on shard 0's device in shard order and
    copied back to every shard, so a sharded solve gives the same bits on
    every run;
  * over a process group (`multihost.global_mesh()`), each process holds
    one shard and the sums are `torch.distributed.all_reduce` (`SUM`,
    `MAX`). The solvers are the same code either way: only the reducer a
    shard is given differs.

`put_global` cuts a problem into the shards: a `SHARDED` leaf along its
first axis by `torch.tensor_split` (eager PyTorch needs no equal shard
sizes, so nothing is padded), a `REPLICATED` leaf whole. JAX's
`initialize_distributed` is `multihost.initialize`; its `replicated` and
`edge_sharded` are `NamedSharding`s and have no counterpart: the specs
below say the same per leaf.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Any, Callable, List, NamedTuple, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

EDGE_AXIS = "edges"  # the mesh axis name, as in the JAX package
#: a leaf's spec: cut along its first axis into one block per shard, or
#: whole on every shard
SHARDED = EDGE_AXIS
REPLICATED = None

#: seconds a shard waits at a reduction for the others before the mesh
#: gives up (a shard that raised breaks the wait at once)
RENDEZVOUS_TIMEOUT = 600.0


class Mesh:
    """An ordered tuple of shard devices along one axis. With
    `process_group`, shard r belongs to rank r of the group and this
    process holds shard `rank`; without, this process holds them all."""

    def __init__(self, devices: Sequence, process_group=None, rank: int = 0):
        self.devices = tuple(torch.device(d) for d in devices)
        if not self.devices:
            raise ValueError("a mesh needs at least one device")
        self.process_group = process_group
        self.rank = rank

    @property
    def size(self) -> int:
        return len(self.devices)

    def local_shards(self) -> List[int]:
        return [self.rank] if self.process_group is not None else list(range(self.size))

    def __repr__(self):
        where = f", rank {self.rank} of a process group" if self.process_group is not None else ""
        return f"Mesh({[str(d) for d in self.devices]}, axis={EDGE_AXIS!r}{where})"

    def run(self, fn: Callable[[Any, Any], Any], shards: "ShardedTree") -> list:
        """`fn(shard, reducer)` on every shard this process holds, one
        thread per shard in one process; the results in shard order."""
        if self.process_group is not None:
            return [fn(shards.trees[0], GroupReducer(self))]
        meet = _Rendezvous(self.devices)
        out: list = [None] * self.size
        errors: list = []

        def work(r):
            try:
                meet.wait_turn(r)
                with _on(self.devices[r]):
                    out[r] = fn(shards.trees[r], ShardReducer(meet, r))
                meet.pass_turn(r)
            except BaseException as e:  # noqa: BLE001 -- re-raised below, after every shard stopped
                errors.append((isinstance(e, _Aborted), r, e))
                meet.abort()

        threads = [threading.Thread(target=work, args=(r,), name=f"mesh-shard-{r}", daemon=True)
                   for r in range(self.size)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        if errors:
            # the shard that failed first, not the others' broken waits
            raise min(errors, key=lambda e: e[:2])[2]
        return out


def make_mesh(n_devices: Optional[int] = None, device: str = "cuda") -> Mesh:
    """A 1-D mesh over the first n visible CUDA devices (default: all). Asking
    for more than are visible raises. `device="cpu"`: n shards on the CPU
    (default 1), the stand-in for JAX's virtual CPU devices."""
    if torch.device(device).type == "cpu":
        return Mesh([torch.device("cpu")] * (n_devices or 1))
    n_visible = torch.cuda.device_count()
    n = n_visible if n_devices is None else n_devices
    if n < 1 or n > n_visible:
        raise RuntimeError(f"a {n}-device mesh needs {n} CUDA devices; {n_visible} visible")
    return Mesh([torch.device("cuda", i) for i in range(n)])


def _on(device: torch.device):
    return torch.cuda.device(device) if device.type == "cuda" else contextlib.nullcontext()


def _wire_device(mesh: Mesh, x: torch.Tensor) -> torch.device:
    """Where a process-group collective takes its tensors: host copies under
    gloo (it takes CPU tensors), the tensor's own device under NCCL."""
    return torch.device("cpu") if dist.get_backend(mesh.process_group) == "gloo" else x.device


# ---------------------------------------------------------------------------
# reductions
# ---------------------------------------------------------------------------


class _Aborted(RuntimeError):
    """Raised in a shard's thread when another shard failed."""


class _Rendezvous:
    """Where the shards of an in-process mesh meet at each reduction. The
    shards take turns in shard order: shard r runs until its next
    reduction, leaves its partial and hands the turn to shard r + 1; the
    last adds the partials on shard 0's device in shard order (the same
    bits on every run) and hands the turn back to shard 0. Each shard reads
    the total when its turn comes again, before it leaves its next partial
    and before the next total is made, so one slot of each suffices. One
    shard runs at a time: with every shard's thread runnable, each op's
    release of the GIL became a hand-off between threads, and 8 shards on
    the CPU ran 30 times slower than one."""

    def __init__(self, devices):
        self.devices = devices
        self.parts: list = [None] * len(devices)
        self.total: Optional[torch.Tensor] = None
        self._turn = [threading.Semaphore(0) for _ in devices]
        self._aborted = False
        self._turn[0].release()

    def wait_turn(self, rank: int) -> None:
        if not self._turn[rank].acquire(timeout=RENDEZVOUS_TIMEOUT) or self._aborted:
            raise _Aborted(f"mesh shard {rank}: another shard failed, or none came in {RENDEZVOUS_TIMEOUT} s")

    def pass_turn(self, rank: int) -> None:
        self._turn[(rank + 1) % len(self.devices)].release()

    def abort(self) -> None:
        self._aborted = True
        for turn in self._turn:
            turn.release()

    def reduce(self, rank: int, x: torch.Tensor, op) -> torch.Tensor:
        self.parts[rank] = x
        if rank == len(self.devices) - 1:
            dev = self.devices[0]
            total = self.parts[0]
            for part in self.parts[1:]:
                total = op(total, part.to(dev))
            self.total = total
        self.pass_turn(rank)
        self.wait_turn(rank)
        # a copy each: no shard's in-place op reaches another's sum
        return self.total.to(self.devices[rank], copy=True)


class ShardReducer:
    """Shard `rank`'s sums and maxima over an in-process mesh."""

    def __init__(self, meet: _Rendezvous, rank: int):
        self._meet = meet
        self.rank = rank

    def sum(self, x: torch.Tensor) -> torch.Tensor:
        return self._meet.reduce(self.rank, x, torch.add)

    def max(self, x: torch.Tensor) -> torch.Tensor:
        return self._meet.reduce(self.rank, x, torch.maximum)


class GroupReducer:
    """This process's sums and maxima over a process-group mesh
    (`torch.distributed.all_reduce`)."""

    def __init__(self, mesh: Mesh):
        self._mesh = mesh

    def _all_reduce(self, x: torch.Tensor, op) -> torch.Tensor:
        y = x.detach().to(_wire_device(self._mesh, x), copy=True)
        dist.all_reduce(y, op=op, group=self._mesh.process_group)
        return y.to(x.device)

    def sum(self, x: torch.Tensor) -> torch.Tensor:
        return self._all_reduce(x, dist.ReduceOp.SUM)

    def max(self, x: torch.Tensor) -> torch.Tensor:
        return self._all_reduce(x, dist.ReduceOp.MAX)


# ---------------------------------------------------------------------------
# placing and gathering
# ---------------------------------------------------------------------------


class ShardedTree(NamedTuple):
    """A tree cut for a mesh: `trees[i]` is the tree of the mesh's i-th
    local shard (`Mesh.local_shards`)."""

    trees: list


def _tree_map(fn, tree, spec):
    """fn(leaf, leaf_spec) over a tree of (named) tuples; `spec` is a tree
    of the same shape, or one spec for every leaf below it."""
    if isinstance(tree, tuple):
        specs = spec if isinstance(spec, tuple) else (spec,) * len(tree)
        vals = [_tree_map(fn, t, s) for t, s in zip(tree, specs)]
        return type(tree)(*vals) if hasattr(tree, "_fields") else type(tree)(vals)
    return fn(tree, spec)


def put_global(tree, specs, mesh: Mesh) -> ShardedTree:
    """The shards of `tree` that this process holds, each on its shard's
    device: a `SHARDED` leaf cut along its first axis into `mesh.size`
    blocks (`torch.tensor_split`: the first `n % size` blocks one row
    longer), a `REPLICATED` leaf whole. Leaves are tensors or numpy arrays
    that every process holds alike."""

    def leaf(r):
        def cut(x, spec):
            x = x if isinstance(x, torch.Tensor) else torch.from_numpy(np.array(x))
            if spec is not REPLICATED:
                x = torch.tensor_split(x, mesh.size)[r]
            return x.to(mesh.devices[r])
        return cut

    return ShardedTree([_tree_map(leaf(r), tree, specs) for r in mesh.local_shards()])


def gather_rows(blocks: List[torch.Tensor], mesh: Mesh) -> torch.Tensor:
    """The row blocks of a `SHARDED` result (one per local shard) joined in
    shard order: on shard 0's device in one process, and on every process
    of a process-group mesh (`all_gather`, blocks padded to the longest)."""
    if mesh.process_group is None:
        dev = mesh.devices[0]
        return torch.cat([b.to(dev) for b in blocks])
    (b,) = blocks
    comm = _wire_device(mesh, b)
    n = torch.tensor([b.shape[0]], dtype=torch.int64, device=comm)
    sizes = [torch.zeros_like(n) for _ in range(mesh.size)]
    dist.all_gather(sizes, n, group=mesh.process_group)
    sizes = [int(s) for s in sizes]
    wire = torch.uint8 if b.dtype == torch.bool else b.dtype  # no bool collectives on gloo
    pad = torch.zeros((max(sizes),) + tuple(b.shape[1:]), dtype=wire, device=comm)
    pad[: b.shape[0]] = b.to(comm, wire)
    parts = [torch.empty_like(pad) for _ in range(mesh.size)]
    dist.all_gather(parts, pad, group=mesh.process_group)
    return torch.cat([p[:s] for p, s in zip(parts, sizes)]).to(b.device, b.dtype)
