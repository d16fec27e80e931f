"""Tracing / profiling utilities.

Port of apf_quadruped_tpu/runtime/profiling.py:

  * `trace(name)`: a named region for torch.profiler
    (`record_function`).  With APF_PROFILE_DIR set, the outermost trace
    also runs a torch.profiler capture (host, and the card where there is
    one) and writes it there as a Chrome trace, `<name>-<pid>-<ns>.json`.
  * `timed(fn)`: wall-clock time per call, fenced by
    torch.cuda.synchronize() when the output lies on a card (a CUDA call
    returns before the card has done the work).
  * `SolverStats.collect(sol)`: batched solver diagnostics (convergence
    fraction, iteration percentiles, residuals), and `pmean_stats`, their
    mean over the processes of a torch.distributed group.
"""

from __future__ import annotations

import contextlib
import contextvars
import os
import time
from typing import Any, Callable, NamedTuple

import numpy as np
import torch

# the capture of the outermost trace() of this context, if any
_capture = contextvars.ContextVar("apf_profile_capture", default=None)


@contextlib.contextmanager
def trace(name: str):
    """Annotate a region for torch.profiler; if APF_PROFILE_DIR is set,
    the outermost trace() also captures a profile and writes it there."""
    prof_dir = os.environ.get("APF_PROFILE_DIR")
    if not prof_dir or _capture.get() is not None:
        with torch.profiler.record_function(name):
            yield
        return
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=activities)
    token = _capture.set(prof)
    try:
        with prof, torch.profiler.record_function(name):
            yield
    finally:
        _capture.reset(token)
    os.makedirs(prof_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(
        prof_dir, f"{name}-{os.getpid()}-{time.time_ns()}.json"))


def _on_cuda(tree) -> bool:
    if isinstance(tree, torch.Tensor):
        return tree.is_cuda
    if isinstance(tree, dict):
        tree = tree.values()
    if isinstance(tree, (list, tuple)):
        return any(_on_cuda(v) for v in tree)
    return False


def timed(fn: Callable, *args, reps: int = 1, warmup: bool = True,
          **kwargs) -> tuple[Any, float]:
    """(result, seconds a call) of `reps` calls after one warm-up call,
    fenced by torch.cuda.synchronize() when the result lies on a card."""
    if warmup:
        out = fn(*args, **kwargs)
        if _on_cuda(out):
            torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        out = fn(*args, **kwargs)
    if _on_cuda(out):
        torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) / max(reps, 1)


class SolverStats(NamedTuple):
    """Aggregate solver health for a batch (qpSWIFT stats equivalent:
    Auxilary.h:55-86 tsolve/iters/residuals, batched)."""

    conv_frac: float
    iters_p50: float
    iters_p99: float
    gap_max: float
    res_max: float

    @classmethod
    def collect(cls, sol) -> "SolverStats":
        def host(v):
            return v.detach().cpu().double().numpy()
        iters = host(sol.iters)
        return cls(
            conv_frac=float(host(sol.converged).mean()),
            iters_p50=float(np.percentile(iters, 50)),
            iters_p99=float(np.percentile(iters, 99)),
            gap_max=float(host(sol.gap).max()),
            res_max=float(host(sol.res_norm).max()))

    def as_dict(self):
        return dict(self._asdict())


def pmean_stats(stats: dict, group=None) -> dict:
    """The mean of each scalar stat over the processes of `group` (the
    default group) by all_reduce; the stats as they are when no process
    group is initialized."""
    import torch.distributed as dist

    from ..parallel.distributed import comm_device

    if not (dist.is_available() and dist.is_initialized()):
        return stats
    world = dist.get_world_size(group)
    out = {}
    for k, v in stats.items():
        t = torch.as_tensor(v)
        comm = t.to(comm_device(group)).clone()
        dist.all_reduce(comm, op=dist.ReduceOp.SUM, group=group)
        out[k] = (comm / world).to(t.device)
    return out
