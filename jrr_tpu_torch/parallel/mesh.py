"""The process mesh and the collectives the data-parallel path issues
(counterpart of jrr_tpu/parallel/mesh.py).

A `Mesh` is the 1-D data axis over the processes of the default
`torch.distributed` group, one GPU each: its world size, this process's
rank and device. jrr_tpu's shardings become row ranges: `shard_batch` gives
this rank its contiguous rows of the global batch, `replicate` broadcasts
rank 0's values onto this rank's device.

The collectives (`sum_over_ranks`, `max_over_ranks`, `gather_rows`,
`barrier`) flatten a whole tree into one all-reduce (or a barrier) and
return their input unchanged when the mesh spans no process group, so a
one-process run issues none. All-reduces alone run on both NCCL and
gloo's CUDA tensors, so several processes can also share one card over
gloo (`chip_smoke.run_multi_gpu(backend="gloo")`).
"""

from __future__ import annotations

import copy
import dataclasses
import itertools
import os
from typing import Any, Callable, NamedTuple, Optional

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from jrr_tpu_torch import resolve_device
from jrr_tpu_torch.refine import engine

DATA_AXIS = "data"


def initialized() -> bool:
    """Whether this process belongs to a `torch.distributed` group."""
    return dist.is_available() and dist.is_initialized()


def local_rank() -> int:
    """This process's GPU index on its host: torchrun's LOCAL_RANK, else
    the rank modulo the host's card count."""
    if "LOCAL_RANK" in os.environ:
        return int(os.environ["LOCAL_RANK"])
    rank = dist.get_rank() if initialized() else 0
    return rank % max(torch.cuda.device_count(), 1)


@dataclasses.dataclass(frozen=True)
class Mesh:
    """The data axis over the processes: `distributed` when they form a
    `torch.distributed` group (collectives are issued, even at world size 1)."""

    world_size: int
    rank: int
    device: torch.device
    distributed: bool
    axis: str = DATA_AXIS

    @property
    def num_devices(self) -> int:
        return self.world_size

    @property
    def is_lead(self) -> bool:
        """Rank 0: the process that writes files and runs the evals."""
        return self.rank == 0


def launch_hint(n: int) -> str:
    return (f"launch one process per GPU: torchrun --nproc_per_node={n} -m jrr_tpu_torch.cli ... "
            "(or jrr_tpu_torch.parallel.multihost.launch_local)")


def make_mesh(num_devices: Optional[int] = None, axis: str = DATA_AXIS, device="cuda") -> Mesh:
    """The mesh over every process of the default group (one process, when
    `torch.distributed` is not initialized). A CUDA device without an index
    becomes this process's card, cuda:LOCAL_RANK. `num_devices`, when
    given, must equal the process count: each process drives one GPU."""
    world, rank = (dist.get_world_size(), dist.get_rank()) if initialized() else (1, 0)
    if num_devices is not None and num_devices != world:
        raise ValueError(f"mesh.num_devices={num_devices} but {world} process(es) run; "
                         + launch_hint(num_devices))
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", local_rank())
    return Mesh(world_size=world, rank=rank, device=dev, distributed=initialized(), axis=axis)


def feasible_device_count(batch_size: int, available: Optional[int] = None) -> int:
    """Largest device count ≤ available that divides the frame batch
    (`available`: the process count when distributed, else the host's
    cards, at least 1)."""
    if available is None:
        available = dist.get_world_size() if initialized() else max(torch.cuda.device_count(), 1)
    n = min(available, batch_size)
    while n > 1 and batch_size % n != 0:
        n -= 1
    return max(n, 1)


class Sharding(NamedTuple):
    """How a tree's leaves lie on the mesh: "replicated" or "batch" (the
    leading axis split into contiguous rows, one range per rank)."""

    mesh: Mesh
    kind: str


def replicated(mesh: Mesh) -> Sharding:
    return Sharding(mesh, "replicated")


def batch_sharding(mesh: Mesh, axis: str = DATA_AXIS) -> Sharding:
    """Shard the leading (frame) axis of every leaf."""
    return Sharding(mesh, "batch")


def local_rows(mesh: Mesh, n: int) -> slice:
    """This rank's contiguous rows of an n-row global batch."""
    if n % mesh.world_size:
        raise ValueError(f"a batch of {n} frames does not split over {mesh.world_size} processes; "
                         "use a batch size the process count divides (feasible_device_count)")
    per = n // mesh.world_size
    return slice(mesh.rank * per, (mesh.rank + 1) * per)


def tree_map(fn: Callable, tree: Any) -> Any:
    """`fn` on every tensor or ndarray leaf of a tree of NamedTuples, tuples,
    lists, dicts, dataclasses, `nn.Module`s (a copy, its parameters and
    buffers mapped) and Adam states (`engine._Adam`: a copy, its moments
    and a count on the device mapped); other leaves stay as they are."""
    if isinstance(tree, (torch.Tensor, np.ndarray)):
        return fn(tree)
    if isinstance(tree, nn.Module):
        out = copy.deepcopy(tree)
        with torch.no_grad():
            for t in itertools.chain(out.parameters(), out.buffers()):
                t.data = fn(t.data)
        return out
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(tree_map(fn, x) for x in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, x) for x in tree)
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(tree, **{f.name: tree_map(fn, getattr(tree, f.name))
                                            for f in dataclasses.fields(tree) if f.init})
    if isinstance(tree, engine._Adam):
        out = copy.copy(tree)
        out.m, out.v = tree_map(fn, tree.m), tree_map(fn, tree.v)
        if torch.is_tensor(tree.count):
            out.count = fn(tree.count)
        return out
    return tree


def _as_tensor(x, device) -> torch.Tensor:
    return x.to(device) if isinstance(x, torch.Tensor) else torch.as_tensor(np.asarray(x), device=device)


def shard_batch(mesh: Mesh, tree: Any, axis: str = DATA_AXIS) -> Any:
    """This rank's contiguous rows of every leaf, on its device."""
    return tree_map(lambda x: _as_tensor(x[local_rows(mesh, x.shape[0])], mesh.device), tree)


def replicate(mesh: Mesh, tree: Any) -> Any:
    """Every leaf on this rank's device with rank 0's values."""
    def put(x):
        t = _as_tensor(x, mesh.device).clone()
        if mesh.distributed:
            dist.broadcast(t, src=0)
        return t

    return tree_map(put, tree)


def _leaves(tree) -> list:
    out = []
    tree_map(lambda x: out.append(x), tree)
    return out


def _unflatten(tree, flat: torch.Tensor):
    """`tree` with its tensor leaves read back, in order, from `flat`."""
    pos = [0]

    def take(x):
        n = x.numel()
        y = flat[pos[0]:pos[0] + n].view(x.shape).to(x.dtype)
        pos[0] += n
        return y

    return tree_map(take, tree)


def _reduce(mesh: Mesh, tree, op):
    if not mesh.distributed:
        return tree
    leaves = _leaves(tree)
    dtype = leaves[0].dtype
    flat = torch.cat([x.reshape(-1).to(dtype) for x in leaves])
    dist.all_reduce(flat, op=op)
    return _unflatten(tree, flat)


def sum_over_ranks(mesh: Mesh, tree):
    """Every tensor leaf summed over the ranks, in one all-reduce (leaves
    flattened into the first leaf's dtype)."""
    return _reduce(mesh, tree, dist.ReduceOp.SUM)


def max_over_ranks(mesh: Mesh, tree):
    """Every tensor leaf's elementwise maximum over the ranks, in one all-reduce."""
    return _reduce(mesh, tree, dist.ReduceOp.MAX)


def gather_rows(mesh: Mesh, tree):
    """Every leaf's rows from all ranks, in rank order: the global batch of
    equal local batches. One all-reduce of a zero-filled global buffer in
    which each rank writes its own rows (exact: every other term is 0; an
    all-reduce runs on gloo's CUDA tensors too, an all-gather does not)."""
    if not mesh.distributed:
        return tree
    leaves = _leaves(tree)
    dtype = leaves[0].dtype
    flat = torch.cat([x.reshape(-1).to(dtype) for x in leaves])
    parts = flat.new_zeros((mesh.world_size, flat.numel()))
    parts[mesh.rank] = flat
    dist.all_reduce(parts)
    per_rank = [_leaves(_unflatten(tree, p)) for p in parts]
    merged = iter([torch.cat(xs, dim=0) for xs in zip(*per_rank)])
    return tree_map(lambda _: next(merged), tree)


def barrier(mesh: Mesh) -> None:
    if mesh.distributed:
        dist.barrier()
