"""Batched steps and calls replayed as captured CUDA graphs.

The JAX package compiles its closed loop's cycle and its plan into XLA
programs (`jax.jit`) and steps through a cycle's ticks as a `lax.scan`,
with no host inside.  The port's counterparts capture the work in a
`torch.cuda.CUDAGraph` and replay it: the same kernels in the same order
on the same data, so the results equal the eager run's bit for bit, and
the host makes one graph launch instead of one launch a kernel.

    carry = scan(key, step, inputs, carry, outs, n)

runs `for k in range(n): carry = step(inputs, carry, k, outs)` on CUDA
tensors, where `step` writes its per-step outputs into the buffers `outs`
at column `k` (a one-element int64 device tensor) and returns the new
carry, a tree (tuples, NamedTuples) of tensors of the old carry's shapes
and dtypes.  Its static buffers hold a copy of the inputs, the carry, the
outputs and `k`; the graph of one step ends by copying the new carry into
the carry buffers and adding one to `k`.  Each call copies the inputs and
the carry in, zeroes `k`, replays `n` times and copies the outputs and
the carry out.

    out = call(key, fn, inputs)

is one replay of a graph of `fn(inputs)` (planner.plan, the cycle's head
and tail in runtime/loop.py, wbc.solve, ops/qpsolve.solve_qp): the
inputs copied into static buffers, the outputs cloned out of the graph's
pool.  A call made inside another graph's capture runs `fn` directly, so
a plan captured inside the cycle's head is part of the head's graph, and
a WBC solve inside the tick's graph part of that.

A graph is captured on the first use of a `key` (which must hash
everything the code branches on) and a layout of the inputs (every
tensor's shape, strides, dtype and device, every other leaf's value, None
included), and cached: at most MAX_GRAPHS graphs of scans and calls
together, the least recently used dropped with its memory pool.  A sweep
holds two for each configuration and batch (the cycle's head and its
tick), a planner one for each configuration, backend and input layout,
wbc.solve and solve_qp called on their own one for each configuration
and input layout.

Before the capture the body runs once eagerly on a side stream on the
buffers, its result discarded: it fills the per-device constant caches
(functools.lru_cache on (cfg, dtype, device)), whose first use is a copy
from host memory that no capture may hold, and loads what loads lazily.
A capture that fails raises; nothing falls back to the eager code.

The kernel wrappers count their launches in Python, which a replay does
not run: the capture records the launches one replay makes, undoes what
the warm-up and the capture added, and each replay adds them, so the
counters go on counting launches on the device.
"""

from __future__ import annotations

import collections
import time
from typing import NamedTuple

import torch

from ..ops import cuda_chol, cuda_riccati

MAX_GRAPHS = 16


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
    """One captured step or call and its static buffers."""

    graph: torch.cuda.CUDAGraph
    inputs: object
    carry: object              # a scan's carry buffers; None for a call
    k: torch.Tensor | None     # a scan's (1,) int64 step index
    outs: object               # a scan's output buffers, a call's outputs
    launches: tuple[int, ...]  # kernel launches a replay makes, by counter
    capture_s: float           # warm-up and capture, host clock
    pool_bytes: int            # device memory the capture reserved


_CACHE: collections.OrderedDict = collections.OrderedDict()

# > 0 while a graph is warmed up or captured: a `call` inside it runs its
# function as part of the outer graph
_nesting = 0


def _capture(body, dev):
    """(graph, what the captured body returned, launches a replay makes,
    seconds, pool bytes): `body()` run once eagerly on a side stream, its
    result discarded, then captured."""
    global _nesting
    t0 = time.perf_counter()
    before = _counts()
    _nesting += 1
    try:
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            body()
        torch.cuda.current_stream(dev).wait_stream(side)
        torch.cuda.synchronize(dev)
        warm = _counts()
        torch.cuda.empty_cache()
        reserved = torch.cuda.memory_reserved(dev)
        graph = torch.cuda.CUDAGraph()
        pool = torch.cuda.graph_pool_handle()
        # thread_local: a host read or copy in the body, on this thread,
        # still breaks the capture and raises; CUDA calls of other threads
        # (NCCL's watchdog in a process group) do not
        try:
            with torch.cuda.graph(graph, pool=pool,
                                  capture_error_mode="thread_local"):
                out = body()
        except BaseException:
            _drop_failed_pool(dev, pool)
            raise
        torch.cuda.synchronize(dev)
    finally:
        _nesting -= 1
    launches = tuple(c - w for c, w in zip(_counts(), warm))
    for f, n in zip(_counters(), before):
        f.launches = n
    return (graph, out, launches, time.perf_counter() - t0,
            torch.cuda.memory_reserved(dev) - reserved)


def _drop_failed_pool(dev, pool):
    """Close the memory pool of a capture that failed.  The capture's end
    raises before it tells the caching allocator that the pool's capture
    is over, so the allocator would go on sending the capture stream's
    later allocations into the dead pool and deferring frees while it
    believes a capture runs: the process's memory would grow without
    bound.  Ended here, and the pool released."""
    try:
        torch._C._cuda_endAllocateToPool(dev.index, pool)
    except RuntimeError:
        pass        # the allocator had closed it: nothing to end
    torch._C._cuda_releasePool(dev.index, pool)


def _cached(full, make) -> Captured:
    """The cached graph of key `full`, captured by `make()` on a miss."""
    entry = _CACHE.get(full)
    if entry is None:
        entry = make()
        _CACHE[full] = entry
        while len(_CACHE) > MAX_GRAPHS:
            _CACHE.popitem(last=False)
    else:
        _CACHE.move_to_end(full)
    return entry


def _replay(entry: Captured, n: int = 1):
    for _ in range(n):
        entry.graph.replay()
    for f, c in zip(_counters(), entry.launches):
        f.launches += c * n


def _cuda_device(tree, what):
    dev = _tensors(tree)[0].device
    if dev.type != "cuda":
        raise ValueError(f"graph.{what} replays a CUDA graph: the tensors "
                         f"are on {dev}")
    return dev


def scan(key, step, inputs, carry, outs, n: int):
    """`n` steps of `carry = step(inputs, carry, k, outs)` on CUDA tensors,
    as replays of the step's captured graph; `outs` are filled in place
    and the final carry is returned in fresh tensors."""
    dev = _cuda_device(carry, "scan")
    full = ("scan", key, dev, _signature(inputs), _signature(carry),
            _signature(outs))

    def make():
        s_inputs = _map(torch.clone, inputs)
        s_carry = _map(torch.clone, carry)
        s_outs = _map(torch.empty_like, outs)
        s_k = torch.zeros(1, dtype=torch.int64, device=dev)

        def body():
            _write_back(s_carry, step(s_inputs, s_carry, s_k, s_outs))
            s_k.add_(1)

        graph, _, launches, secs, nbytes = _capture(body, dev)
        return Captured(graph, s_inputs, s_carry, s_k, s_outs, launches,
                        secs, nbytes)

    with torch.cuda.device(dev):
        entry = _cached(full, make)
        for d, s in zip(_tensors(entry.inputs) + _tensors(entry.carry),
                        _tensors(inputs) + _tensors(carry)):
            d.copy_(s)
        entry.k.zero_()
        _replay(entry, n)
        for d, s in zip(_tensors(outs), _tensors(entry.outs)):
            d.copy_(s)
        return _map(torch.clone, entry.carry)


def call(key, fn, inputs):
    """`fn(inputs)` on CUDA tensors as one replay of its captured graph.

    The graph is captured at the first call of a `key` (which must hash
    everything fn's code branches on) and a layout of `inputs`, and
    cached beside the scans'.  Each call copies the inputs into the
    graph's static buffers, replays once and returns the outputs: a
    tensor leaf cloned out of the pool (the next call of the same key
    overwrites it), or, where fn returned one of its inputs as it is, the
    caller's tensor; other leaves as the capture returned them.  Inside
    another graph's warm-up or capture, or while the current stream
    captures, fn runs directly and becomes part of that graph."""
    dev = _cuda_device(inputs, "call")
    if _nesting or torch.cuda.is_current_stream_capturing():
        return fn(inputs)
    full = ("call", key, dev, _signature(inputs))

    def make():
        s_inputs = _map(torch.clone, inputs)
        graph, outs, launches, secs, nbytes = _capture(
            lambda: fn(s_inputs), dev)
        return Captured(graph, s_inputs, None, None, outs, launches, secs,
                        nbytes)

    with torch.cuda.device(dev):
        entry = _cached(full, make)
        given = _tensors(inputs)
        for d, s in zip(_tensors(entry.inputs), given):
            d.copy_(s)
        _replay(entry)
        passed = {id(d): s for d, s in zip(_tensors(entry.inputs), given)}
        return _map(lambda t: passed[id(t)] if id(t) in passed
                    else t.clone(), entry.outs)


def entries() -> list[Captured]:
    """The cached graphs, least recently used first."""
    return list(_CACHE.values())


def clear():
    """Drop every cached graph and its memory pool."""
    _CACHE.clear()
