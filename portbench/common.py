"""What every kind of traffic shares: the card, the clock, trees of
tensors, the comparison with the reference, and the result line."""

from __future__ import annotations

import json
import os
import sys

import numpy as np
import torch

# top-level module names that may not be loaded in a run's process
FORBIDDEN = ("jax", "jaxlib", "flax", "apf_quadruped_tpu")


def process_age() -> float:
    """Seconds since this process started (its start as the kernel
    recorded it, so interpreter start-up and imports count)."""
    with open("/proc/self/stat") as f:
        fields = f.read().rsplit(")", 1)[1].split()
    start = int(fields[19]) / os.sysconf("SC_CLK_TCK")
    with open("/proc/uptime") as f:
        return float(f.read().split()[0]) - start


def forbidden_modules() -> list[str]:
    """The loaded modules whose top-level name is a forbidden one, the
    names compared whole."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def sync(device=None):
    """Wait for the card, where the run has one."""
    if torch.cuda.is_available() and (device is None
                                      or torch.device(device).type == "cuda"):
        torch.cuda.synchronize()


class Reservoir:
    """A uniform sample of at most `k` items of a stream, drawn from a
    seeded generator (the same stream and seed keep the same items)."""

    def __init__(self, k: int, gen: np.random.Generator):
        self.k, self.gen, self.items, self.seen = k, gen, [], 0

    def offer(self, item):
        if len(self.items) < self.k:
            self.items.append(item)
        else:
            j = int(self.gen.integers(0, self.seen + 1))
            if j < self.k:
                self.items[j] = item
        self.seen += 1


# -- trees of tensors (tuples and NamedTuples) ---------------------------

def tmap(fn, tree):
    """`tree` with fn applied to each tensor leaf; other leaves kept."""
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, tuple):
        vals = [tmap(fn, v) for v in tree]
        return type(tree)(*vals) if hasattr(tree, "_fields") else tuple(vals)
    return tree


def take(tree, lanes):
    """Each tensor leaf's rows `lanes` (the batch axis is the first)."""
    idx = torch.as_tensor(lanes, dtype=torch.int64)
    return tmap(lambda t: t.index_select(0, idx.to(t.device)), tree)


def concat(trees):
    """The trees' tensor leaves joined on the batch axis (the first); other
    leaves taken from the first tree."""
    first = trees[0]
    if isinstance(first, torch.Tensor):
        return torch.cat(trees)
    if isinstance(first, tuple):
        vals = [concat([t[i] for t in trees]) for i in range(len(first))]
        return type(first)(*vals) if hasattr(first, "_fields") else tuple(vals)
    return first


def floats_to(tree, dtype, device="cpu"):
    """Every tensor leaf on `device`, floating ones in `dtype`."""
    return tmap(lambda t: t.to(device=device, dtype=dtype)
                if t.is_floating_point() else t.to(device), tree)


def recast(tree, types: dict):
    """`tree` rebuilt with the NamedTuple classes of `types` (by class
    name): the program's trees as the reference's."""
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        cls = types[type(tree).__name__]
        return cls(*(recast(v, types) for v in tree))
    if isinstance(tree, tuple):
        return tuple(recast(v, types) for v in tree)
    return tree


def reference_types() -> dict:
    """The reference's NamedTuple classes by name."""
    from .reference import apf, planner, wbc
    from .reference.ops import qpsolve, riccati
    from .reference.runtime import loop, observer
    from .reference.sim import physics, terrain
    classes = (loop.LoopState, loop.CycleMetrics, physics.SimState,
               apf.ApfState, observer.ObserverState, terrain.Terrain,
               wbc.WbcState, wbc.WbcRefs, wbc.WbcOutput, planner.MpcRefs,
               planner.MpcPlan, riccati.WarmStart, qpsolve.QPSolution)
    return {c.__name__: c for c in classes}


def lane_gaps(judged, ref64, ref32):
    """Per lane (rows of the first axis): (|judged - ref64| max, |ref32 -
    ref64| max, |ref64| max) over every element of every leaf given, as
    float64 numpy arrays.  `judged`, `ref64` and `ref32` are lists of
    tensors of one shape each."""
    d = s = m = None
    for a, r, r32 in zip(judged, ref64, ref32):
        a, r, r32 = (np.asarray(v.detach().cpu().double().numpy())
                     .reshape(v.shape[0], -1) for v in (a, r, r32))
        dd = np.abs(a - r).max(axis=1)
        ss = np.abs(r32 - r).max(axis=1)
        mm = np.abs(r).max(axis=1)
        dd = np.where(np.isfinite(dd), dd, np.inf)
        d = dd if d is None else np.maximum(d, dd)
        s = ss if s is None else np.maximum(s, ss)
        m = mm if m is None else np.maximum(m, mm)
    return d, s, m


def change_ratios(judged, ref, start, floor: float) -> np.ndarray:
    """Per leaf and lane (leaves x lanes): how far the judged end state
    lies from the reference's, as a share of how far the reference's
    state moved from the common start (each distance the widest element
    of the lane's leaf, the latter floored at `floor` (1 + |reference|)).
    A state left at its start reads 1."""
    out = []
    for a, r, s0 in zip(judged, ref, start):
        a, r, s0 = (np.asarray(v.detach().cpu().double().numpy())
                    .reshape(v.shape[0], -1) for v in (a, r, s0))
        d = np.abs(a - r).max(axis=1)
        moved = np.abs(s0 - r).max(axis=1)
        d = np.where(np.isfinite(d), d, np.inf)
        out.append(d / (moved + floor * (1.0 + np.abs(r).max(axis=1))))
    return np.stack(out)


def iters_short(own, judged) -> int:
    """The most iterations by which a judged lane stopped before the
    float64 reference's own stop at the configuration's tolerances, over
    the lanes (0 where none stopped before it)."""
    own = np.asarray(torch.as_tensor(own).cpu().numpy(), dtype=np.int64)
    judged = np.asarray(torch.as_tensor(judged).cpu().numpy(),
                        dtype=np.int64)
    return int(max(0, (own.reshape(-1) - judged.reshape(-1)).max()))


def gap_ratio(d, s, m, floor: float) -> np.ndarray:
    """Per lane: the judged side's distance from the float64 reference
    over the reference's own float32 distance from it, the latter floored
    at `floor` (1 + |reference|): how many float32 roundings apart the
    judged answer lies."""
    return d / (s + floor * (1.0 + m))


# -- the result line -----------------------------------------------------

def device_info(device, count: int) -> dict:
    if torch.device(device).type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": count,
                "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": count,
            "memory_peak_bytes": int(max(torch.cuda.max_memory_allocated(d)
                                         for d in range(count)))}


def emit(result: dict, checks: dict):
    """Print each number compared beside its limit as the last lines on
    standard error, and the result as one JSON line, last on standard
    output, with the checks as its last key."""
    for name, c in checks.items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr, flush=True)
    print(json.dumps({**result, "checks": checks}), flush=True)
