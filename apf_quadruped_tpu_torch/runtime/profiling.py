"""Tracing / profiling utilities.

Port of apf_quadruped_tpu/runtime/profiling.py:

  * `trace(*name)`: a host span named `apf: <name>` while a
    torch.profiler session records (`record_function`; the session's
    device trace shares its clock, so an idle gap on the device falls
    under the span that held the host); otherwise a shared null context,
    after one check of the profiler's state (`recording()`, which a
    caller of several spans checks once to skip them all).
  * `mark(stage, like)` and the switch `marks(on)`: with marks on and
    `like` on a card, an empty one-thread kernel `apf_mark_kernel<ID>`
    launched at a stage boundary (eagerly, or as a node of the graph
    being captured), which a device trace shows by name, ID = the
    stage's index in STAGES; off by default, and a no-op on the CPU.
    runtime/graph.py keys every graph on the switch, so a graph captured
    with marks never serves a call without them, nor the reverse.
  * `timed(fn)`: wall-clock time per call, fenced by
    torch.cuda.synchronize() when the output lies on a card (a CUDA call
    returns before the card has done the work).
  * `SolverStats.collect(sol)`: batched solver diagnostics (convergence
    fraction, iteration percentiles, residuals), and `pmean_stats`, their
    mean over the processes of a torch.distributed group.
"""

from __future__ import annotations

import contextlib
import ctypes
import time
from typing import Any, Callable, NamedTuple

import numpy as np
import torch

# the prefix of every span's name in a trace
PREFIX = "apf: "

_NULL = contextlib.nullcontext()


def recording() -> bool:
    """Whether a torch.profiler session records on this thread."""
    return torch.autograd._profiler_enabled()


def trace(*name):
    """A span `apf: <name>` (the parts joined by spaces) for the profiler
    that records, or a shared null context where none does."""
    if not torch.autograd._profiler_enabled():
        return _NULL
    return torch.profiler.record_function(
        PREFIX + " ".join(str(p) for p in name))


# the stages a mark opens, in the order of their IDs: a tick (loop._step),
# the WBC solve (wbc._solve_impl, inside the tick and alone) and the
# Riccati plan (planner._plan_riccati); each `*.end` closes its unit
STAGES = ("tick.refs", "wbc.build", "wbc.qp", "wbc.torque", "wbc.end",
          "physics", "tick.tail", "tick.end", "plan.pack", "plan.ipm",
          "plan.unpack", "plan.end")
_STAGE_ID = {s: i for i, s in enumerate(STAGES)}

_marks_on = False


def marks_on() -> bool:
    """Whether `mark` launches its kernels."""
    return _marks_on


@contextlib.contextmanager
def marks(on: bool = True):
    """Stage marks on (or off) inside the block; on a machine with a card
    the marks' library is built and loaded on the first entry with marks
    on."""
    global _marks_on
    if on and torch.cuda.is_available():
        from .. import _kernels
        _kernels.apf_mark()
    old, _marks_on = _marks_on, bool(on)
    try:
        yield
    finally:
        _marks_on = old


def mark(stage: str, like: torch.Tensor):
    """The start of `stage` (one of STAGES) on the device: with marks on
    and `like` on a card, apf_mark_kernel<ID> on the current stream;
    otherwise nothing."""
    sid = _STAGE_ID[stage]
    if not _marks_on or like.device.type != "cuda":
        return
    from .. import _kernels
    dev = like.device
    with torch.cuda.device(dev):
        err = _kernels.apf_mark().apf_mark_launch(
            sid, ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream))
    if err:
        raise RuntimeError(f"apf_mark_launch({stage}) failed: CUDA error "
                           f"{err}")


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
