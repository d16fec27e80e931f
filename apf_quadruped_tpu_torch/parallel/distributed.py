"""Process-group initialization for sweeps over several processes.

Port of apf_quadruped_tpu/parallel/distributed.py.  One call per process:

    from apf_quadruped_tpu_torch.parallel import distributed
    distributed.ensure_initialized()     # no-op for a single process
    mesh = mesh_mod.scenario_mesh()      # this process's share of the job

after which runtime.sweep.run_sharded splits the job's scenario batch
over every process's devices, gathers the result on every process with
all_gather and averages the statistics with all_reduce.

The settings come from the arguments or, as torchrun sets them, from the
environment: MASTER_ADDR, MASTER_PORT, WORLD_SIZE and RANK.  The backend
is NCCL where CUDA is available and gloo otherwise.
"""

from __future__ import annotations

import os

import torch
import torch.distributed as dist


def ensure_initialized(coordinator: str | None = None,
                       num_processes: int | None = None,
                       process_id: int | None = None) -> bool:
    """Initialize the torch.distributed process group once.  coordinator:
    "host:port" of rank 0.  Returns True if a group of more than one
    process is active, False for the single-process case (no settings
    given: nothing is initialized)."""
    if dist.is_initialized():
        return dist.get_world_size() > 1
    env = os.environ
    if coordinator is None and "MASTER_ADDR" in env and "MASTER_PORT" in env:
        coordinator = f"{env['MASTER_ADDR']}:{env['MASTER_PORT']}"
    if num_processes is None and "WORLD_SIZE" in env:
        num_processes = int(env["WORLD_SIZE"])
    if process_id is None and "RANK" in env:
        process_id = int(env["RANK"])
    if coordinator is None:
        return False
    if num_processes is None or process_id is None:
        raise ValueError("a coordinator needs the number of processes and "
                         "this process's id (WORLD_SIZE and RANK)")
    backend = "nccl" if torch.cuda.is_available() else "gloo"
    if backend == "nccl":
        torch.cuda.set_device(int(env.get("LOCAL_RANK", process_id))
                              % torch.cuda.device_count())
    dist.init_process_group(backend, init_method=f"tcp://{coordinator}",
                            world_size=num_processes, rank=process_id)
    return num_processes > 1


def process_group() -> tuple[int, int]:
    """(rank, world size) of the process group, (0, 1) without one."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def comm_device(group=None) -> torch.device:
    """Where a collective of `group` wants its tensors: the current card
    under NCCL, the host under gloo."""
    if dist.get_backend(group) == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def process_info() -> dict:
    """The JAX package's keys: this process's index, the number of
    processes, and the devices (CUDA cards, or the host) per process and
    in all."""
    rank, world = process_group()
    local = torch.cuda.device_count() if torch.cuda.is_available() else 1
    return {"process_index": rank, "process_count": world,
            "local_devices": local, "global_devices": local * world}
