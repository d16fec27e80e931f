"""Device meshes for scenario-parallel sweeps.

Port of apf_quadruped_tpu/parallel/mesh.py.  One axis ("scenario") is all
this workload needs: the batch of scenarios is split in contiguous
chunks, one per device entry, and each chunk runs the batched closed loop
on its device.  A mesh is the list of torch devices of the whole job;
each process holds its share of it, `devices[rank * k:(rank + 1) * k]`
with k = len(devices) / world size, with the rank and world size of the
torch.distributed process group when one is initialized (one process,
rank 0, otherwise).  A sharded tree is a Python list of trees, one per
entry of the process's share, each on its device.

Entries may repeat: `["cpu", "cpu"]` or `["cuda:0", "cuda:0"]` split the
batch in two chunks that run one after the other on one device.  That is
how a test on the CPU, or a run on one card, exercises the split, its
gather and its statistics, as the JAX package's tests do on virtual CPU
devices.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch
import torch.distributed as dist

from .._device import resolve_device
from .distributed import comm_device, process_group

SCENARIO_AXIS = "scenario"


class ScenarioMesh(NamedTuple):
    devices: tuple       # this process's entries (torch.device)
    rank: int
    world: int

    @property
    def size(self) -> int:
        """Entries in the whole job: the number of chunks of a batch."""
        return len(self.devices) * self.world


def scenario_mesh(devices=None) -> ScenarioMesh:
    """This process's share of `devices`, the whole job's list.  The
    default is this process's CUDA devices: every visible card alone, in a
    process group the card distributed.ensure_initialized made current."""
    rank, world = process_group()
    if devices is None:
        resolve_device("cuda", ask_cpu="a list of CPU devices")
        if world == 1:
            local = [torch.device("cuda", i)
                     for i in range(torch.cuda.device_count())]
        else:
            local = [torch.device("cuda", torch.cuda.current_device())]
        return ScenarioMesh(tuple(local), rank, world)
    devices = [torch.device(d) for d in devices]
    if not devices or len(devices) % world:
        raise ValueError(f"{len(devices)} devices do not split over "
                         f"{world} processes")
    k = len(devices) // world
    for d in devices[rank * k:(rank + 1) * k]:
        resolve_device(d, ask_cpu="CPU devices")
    return ScenarioMesh(tuple(devices[rank * k:(rank + 1) * k]), rank, world)


def tree_map(fn: Callable, tree, *rest):
    """fn over the tensor leaves of NamedTuples / dicts / lists / tuples
    (the other leaves, None among them, pass through)."""
    if isinstance(tree, torch.Tensor):
        return fn(tree, *rest)
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(tree_map(fn, *xs) for xs in zip(tree, *rest)))
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, *xs) for xs in zip(tree, *rest))
    return tree


def _batch(tree) -> int:
    sizes = set()
    tree_map(lambda x: sizes.add(x.shape[0]), tree)
    if len(sizes) != 1:
        raise ValueError(f"leading axes differ: {sorted(sizes)}")
    return sizes.pop()


def shard_batch(mesh: ScenarioMesh, tree) -> list:
    """The job's batch `tree` (every process passes all of it) -> this
    process's chunks of the leading axis, one per device entry, each moved
    to its device.  The batch must divide evenly over the mesh."""
    n = _batch(tree)
    if n % mesh.size:
        raise ValueError(f"a batch of {n} does not divide over {mesh.size} "
                         f"devices (pad_to_devices)")
    per = n // mesh.size
    first = mesh.rank * len(mesh.devices)
    return [tree_map(lambda x: x[(first + i) * per:(first + i + 1) * per]
                     .to(dev), tree) for i, dev in enumerate(mesh.devices)]


def replicate(mesh: ScenarioMesh, tree) -> list:
    """A copy of `tree` on every device entry of this process."""
    return [tree_map(lambda x: x.to(dev), tree) for dev in mesh.devices]


def all_gather_cat(x: torch.Tensor) -> torch.Tensor:
    """Every process's `x` (one shape on all), concatenated on the leading
    axis in rank order; `x` itself without a process group."""
    if not (dist.is_available() and dist.is_initialized()):
        return x
    world = dist.get_world_size()
    y = x.to(comm_device())
    if y.dtype == torch.bool:          # neither NCCL nor gloo gathers bool
        y = y.to(torch.uint8)
    parts = [torch.empty_like(y) for _ in range(world)]
    dist.all_gather(parts, y.contiguous())
    return torch.cat(parts).to(device=x.device, dtype=x.dtype)


def gather(mesh: ScenarioMesh, shards: list):
    """A sharded tree -> the job's whole batch, on this process's first
    device entry (every process gets all of it)."""
    dev = mesh.devices[0]
    return tree_map(lambda *xs: all_gather_cat(torch.cat([x.to(dev)
                                                          for x in xs])),
                    *shards)


def sharded_map(mesh: ScenarioMesh, fn: Callable, reduce_stats: bool = True):
    """Wrap a per-shard batched function over the scenario mesh.

    fn: (shard tree) -> (out tree, {name: scalar stat}).  The wrapped
    function takes a sharded tree and returns the gathered whole-batch
    output and the stats averaged over the shards and then over the
    processes (with reduce_stats=False, the list of this process's
    per-shard stats)."""
    from ..runtime.profiling import pmean_stats

    def wrapped(shards):
        outs = [fn(s) for s in shards]
        out = gather(mesh, [o for o, _ in outs])
        stats = [s for _, s in outs]
        if not reduce_stats:
            return out, stats
        dev = mesh.devices[0]
        local = {k: torch.stack([torch.as_tensor(s[k]).to(dev)
                                 for s in stats]).mean()
                 for k in stats[0]}
        return out, pmean_stats(local)

    return wrapped


def pad_to_devices(n: int, n_devices: int) -> int:
    """Smallest multiple of n_devices >= n (scenario batches must divide
    evenly across the mesh)."""
    return ((n + n_devices - 1) // n_devices) * n_devices
