"""A batched step replayed as a captured CUDA graph.

The JAX package compiles its closed loop's tick into one XLA program and
steps through the ticks as a `lax.scan`, with no host in the loop.  The
port's counterpart captures one step in a `torch.cuda.CUDAGraph` and
replays it once a step: the same kernels in the same order on the same
data, so the results equal the eager step's bit for bit, and the host
makes one graph launch a step instead of one launch a kernel.

    carry = scan(key, step, inputs, carry, outs, n)

runs `for k in range(n): carry = step(inputs, carry, k, outs)` on CUDA
tensors, where `step` writes its per-step outputs into the buffers `outs`
at column `k` (a one-element int64 device tensor) and returns the new
carry, a tree (tuples, NamedTuples) of tensors of the old carry's shapes
and dtypes.  The graph of one step is captured on the first call of a
`key` (which must hash everything the step's code branches on) and a
layout of the inputs (every tensor's shape, strides, dtype and device,
every other leaf's value), and cached: at most MAX_GRAPHS graphs, the
least recently used dropped with its memory pool.  Its static buffers
hold a copy of the inputs, the carry, the outputs and `k`; the graph
ends by copying the new carry into the carry buffers and adding one to
`k`.  Each call copies the inputs and the carry in, zeroes `k`, replays
`n` times and copies the outputs and the carry out, since the next call
of the same key overwrites the buffers.

Before the capture one eager step runs on a side stream on the buffers,
its result discarded: it fills the per-device constant caches
(functools.lru_cache on (cfg, dtype, device)), whose first use is a copy
from host memory that no capture may hold, and loads what loads lazily.
A capture that fails raises; nothing falls back to the eager step.

The kernel wrappers count their launches in Python, which a replay does
not run: the capture records the launches one step makes, undoes what
the warm-up and the capture added, and each replay adds them, so the
counters go on counting launches on the device.
"""

from __future__ import annotations

import collections
import time
from typing import NamedTuple

import torch

from ..ops import cuda_chol, cuda_riccati

MAX_GRAPHS = 8


def _counters():
    """The kernel wrappers, each with its `launches` count."""
    return (cuda_chol.chol_factor, cuda_chol.chol_sub, cuda_chol.chol_solve,
            cuda_riccati.solve_stage_qp_resident, cuda_riccati.fused_rollout,
            cuda_riccati.fused_factor, cuda_riccati.fused_vector)


def _counts() -> tuple[int, ...]:
    return tuple(f.launches for f in _counters())


def _tensors(tree) -> list[torch.Tensor]:
    """The tensor leaves of a tree of tuples, in order."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, tuple):
        return [t for v in tree for t in _tensors(v)]
    return []


def _map(fn, tree):
    """`tree` with `fn` applied to each tensor leaf; other leaves kept."""
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, tuple):
        vals = [_map(fn, v) for v in tree]
        return type(tree)(*vals) if hasattr(tree, "_fields") else tuple(vals)
    return tree


def _signature(tree):
    """What a captured graph depends on: each tensor's shape, strides,
    dtype and device, each other leaf's value (None included)."""
    if isinstance(tree, torch.Tensor):
        return (tuple(tree.shape), tree.stride(), tree.dtype, tree.device)
    if isinstance(tree, tuple):
        return (type(tree).__name__, tuple(_signature(v) for v in tree))
    return tree


def _write_back(dst_tree, src_tree):
    """Copy the new carry into the carry buffers, leaf by leaf.  A leaf the
    step passed through unchanged is skipped; a new leaf that is a view of
    a carry buffer raises, as the copies would overwrite it."""
    dst, src = _tensors(dst_tree), _tensors(src_tree)
    if len(dst) != len(src):
        raise ValueError(f"the step returned {len(src)} carry tensors for "
                         f"{len(dst)}")
    held = {t.untyped_storage().data_ptr() for t in dst}
    for i, (d, s) in enumerate(zip(dst, src)):
        if s is d:
            continue
        if (s.shape, s.dtype, s.device) != (d.shape, d.dtype, d.device):
            raise ValueError(
                f"carry leaf {i}: the step returned {tuple(s.shape)} "
                f"{s.dtype} on {s.device} for {tuple(d.shape)} {d.dtype} on "
                f"{d.device}")
        if s.untyped_storage().data_ptr() in held:
            raise ValueError(f"carry leaf {i}: the step returned a view of "
                             f"the carry")
        d.copy_(s)


class Captured(NamedTuple):
    """One captured step and its static buffers."""

    graph: torch.cuda.CUDAGraph
    inputs: object
    carry: object
    k: torch.Tensor            # (1,) int64, the step index
    outs: object
    launches: tuple[int, ...]  # kernel launches a replay makes, by counter
    capture_s: float           # warm-up and capture, host clock
    pool_bytes: int            # device memory the capture reserved


_CACHE: collections.OrderedDict = collections.OrderedDict()


def _capture(step, inputs, carry, outs, dev) -> Captured:
    t0 = time.perf_counter()
    before = _counts()
    s_inputs = _map(torch.clone, inputs)
    s_carry = _map(torch.clone, carry)
    s_outs = _map(torch.empty_like, outs)
    s_k = torch.zeros(1, dtype=torch.int64, device=dev)
    side = torch.cuda.Stream(dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(side):
        step(s_inputs, s_carry, s_k, s_outs)
    torch.cuda.current_stream(dev).wait_stream(side)
    torch.cuda.synchronize(dev)
    warm = _counts()
    torch.cuda.empty_cache()
    reserved = torch.cuda.memory_reserved(dev)
    graph = torch.cuda.CUDAGraph()
    # thread_local: a host read or copy in the step, on this thread, still
    # breaks the capture and raises; CUDA calls of other threads (NCCL's
    # watchdog in a process group) do not
    with torch.cuda.graph(graph, capture_error_mode="thread_local"):
        _write_back(s_carry, step(s_inputs, s_carry, s_k, s_outs))
        s_k.add_(1)
    torch.cuda.synchronize(dev)
    launches = tuple(c - w for c, w in zip(_counts(), warm))
    for f, n in zip(_counters(), before):
        f.launches = n
    return Captured(graph, s_inputs, s_carry, s_k, s_outs, launches,
                    time.perf_counter() - t0,
                    torch.cuda.memory_reserved(dev) - reserved)


def scan(key, step, inputs, carry, outs, n: int):
    """`n` steps of `carry = step(inputs, carry, k, outs)` on CUDA tensors,
    as replays of the step's captured graph; `outs` are filled in place
    and the final carry is returned in fresh tensors."""
    dev = _tensors(carry)[0].device
    if dev.type != "cuda":
        raise ValueError(f"graph.scan replays a CUDA graph: the carry is on "
                         f"{dev}")
    full = (key, dev, _signature(inputs), _signature(carry),
            _signature(outs))
    with torch.cuda.device(dev):
        entry = _CACHE.get(full)
        if entry is None:
            entry = _capture(step, inputs, carry, outs, dev)
            _CACHE[full] = entry
            while len(_CACHE) > MAX_GRAPHS:
                _CACHE.popitem(last=False)
        else:
            _CACHE.move_to_end(full)
        for d, s in zip(_tensors(entry.inputs) + _tensors(entry.carry),
                        _tensors(inputs) + _tensors(carry)):
            d.copy_(s)
        entry.k.zero_()
        for _ in range(n):
            entry.graph.replay()
        for f, c in zip(_counters(), entry.launches):
            f.launches += c * n
        for d, s in zip(_tensors(outs), _tensors(entry.outs)):
            d.copy_(s)
        return _map(torch.clone, entry.carry)


def entries() -> list[Captured]:
    """The cached graphs, least recently used first."""
    return list(_CACHE.values())


def clear():
    """Drop every cached graph and its memory pool."""
    _CACHE.clear()
