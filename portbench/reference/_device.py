"""The device rule of the port's entry points, and its device constants.

The entry points a user calls (`problems.bench_problem`,
`runtime.sweep.random_scenarios`, `runtime.loop.init`,
`parallel.mesh.scenario_mesh()`, the commands and their `run_closed_loop`
and `bench_rate`) put their tensors on the CUDA card unless the caller
asks for the CPU; every other function follows its input tensors' device.  Without a
card, asking for it raises, naming how to ask for the CPU instead: there
is no silent fallback.
"""

from __future__ import annotations

import functools

import torch


def resolve_device(device, ask_cpu: str = "device='cpu'") -> torch.device:
    """torch.device(device), after checking that a CUDA device exists when
    one is asked for; `ask_cpu` names the argument that selects the CPU."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"no CUDA device is available (torch.cuda.is_available() is "
            f"False): pass {ask_cpu} to run on the CPU")
    return device


@functools.lru_cache(maxsize=None)
def constant(value, dtype, device) -> torch.Tensor:
    """torch.tensor(value, dtype, device), built once per (value, dtype,
    device) and shared: never write into it.  A copy from host memory on
    every call would wait for the device, and a captured CUDA graph
    (runtime/graph.py) cannot hold one.  `value` is a number or a tuple of
    them, compared by value (0.0 and -0.0 share an entry): the callers
    pass configuration values and fixed literals."""
    return torch.tensor(value, dtype=dtype, device=device)
