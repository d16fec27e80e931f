"""The device trace of a traced window, read from torch.profiler.

`profile(fn, launched)` runs `fn()` (which ends in a synchronize) under
the profiler, host and device, and reads the device's operations (kernels,
copies, sets) with their intervals and the host's operations with theirs.
Its guard is chip_smoke.window's: a profiler may record fewer launches
than were made, so the kernels of the port's own CUDA libraries that the
trace recorded are compared with the launches that the program's counters
(runtime/graph.py adds a replay's launches) say were made, and a window
that recorded under 95% of them is profiled again, up to `tries` windows;
the best is kept and its share reported.  Where no window reached 95%,
the trace is marked as lossy, and the per-layer metrics read from the
device's operations leave themselves out of the result.
"""

from __future__ import annotations

import re
from typing import NamedTuple

import numpy as np
import torch

# the port's own kernels (csrc/spd_chol.cu, resident_ipm.cu,
# fused_riccati.cu), whose launches runtime/graph.py's counters count
OWN = re.compile(r"\b(spd_\w+_kernel|resident_ipm\w*_kernel|rollout_kernel|"
                 r"factor_kernel|vector_kernel)\s*[<(]")


# the prefix of the benchmark's own spans around its calls into the program
SPAN = "portbench: "


def span(name: str):
    """A span of the benchmark's own around its call `name` into the
    program, for the profiler."""
    return torch.profiler.record_function(SPAN + name)


class Trace(NamedTuple):
    kernels: list        # [(name, start_us, end_us)] device operations
    host: list           # [(name, start_us, end_us)] host operations
    window_s: float      # first to last recorded event
    busy_s: float        # the union of the device intervals
    share: float         # counted kernels recorded / launched
    tries: int
    lossless: bool       # share reached the guard's minimum

    @property
    def idle_share(self) -> float:
        return 1.0 - self.busy_s / self.window_s

    def by_name(self) -> dict:
        """{device operation: (count, seconds)}."""
        out = {}
        for name, a, b in self.kernels:
            c, s = out.get(name, (0, 0.0))
            out[name] = (c + 1, s + (b - a) * 1e-6)
        return out

    def breakdown(self, top: int = 10) -> dict:
        """The device operations that took most time, and the device's
        idle time by what the host was doing then (the innermost host
        operation under the middle of each gap), each at most `top`."""
        ops = sorted(((n, s) for n, (_, s) in self.by_name().items()),
                     key=lambda x: -x[1])[:top]
        gaps = {}
        spans = np.array(_gaps(self.kernels, self._bounds())).reshape(-1, 2)
        hs = np.array([(a, b) for _, a, b in self.host]).reshape(-1, 2)
        names = [n for n, _, _ in self.host]
        dur = hs[:, 1] - hs[:, 0]
        for lo in range(0, len(spans), 4096):
            part = spans[lo:lo + 4096]
            mid = 0.5 * (part[:, 0] + part[:, 1])[:, None]
            under = (hs[None, :, 0] <= mid) & (mid <= hs[None, :, 1])
            inner = np.where(under, dur[None, :], np.inf).argmin(axis=1)
            for (a, b), i, any_ in zip(part, inner, under.any(axis=1)):
                name = names[i] if any_ else "host: no operation recorded"
                gaps[name] = gaps.get(name, 0.0) + float(b - a) * 1e-6
        idle = sorted(gaps.items(), key=lambda x: -x[1])[:top]
        return {"device_ops": [[n, s] for n, s in ops],
                "idle_gaps": [[n, s] for n, s in idle]}

    def _bounds(self):
        ts = [e[1] for e in self.kernels + self.host]
        te = [e[2] for e in self.kernels + self.host]
        return min(ts), max(te)


def _union(intervals) -> list:
    merged = []
    for a, b in sorted((a, b) for _, a, b in intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return merged


def _gaps(kernels, bounds):
    lo, hi = bounds
    edges = [lo]
    for a, b in _union(kernels):
        edges += [a, b]
    edges.append(hi)
    return [(a, b) for a, b in zip(edges[0::2], edges[1::2]) if b > a]


def counted(kernels) -> int:
    """How many of `kernels` are the port's own, counted ones."""
    return sum(1 for name, _, _ in kernels if OWN.search(name))


def _read(prof) -> tuple[list, list]:
    """(device operations, host operations).  A host range the profiler
    mirrors on the device's timeline (a `record_function` span, which
    covers every kernel under it) is not a device operation."""
    dev, host = [], []
    for e in prof.events():
        rec = (e.name, float(e.time_range.start), float(e.time_range.end))
        if e.device_type != torch.autograd.DeviceType.CUDA:
            host.append(rec)
        elif not (getattr(e, "is_user_annotation", False)
                  or e.name.startswith(SPAN)):
            dev.append(rec)
    return dev, host


def profile(fn, launches, min_share: float = 0.95, tries: int = 4) -> Trace:
    """The Trace of `fn()` (which synchronizes at its end); `launches()`
    gives the program's launch counters (a tuple summed here) before and
    after."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    best = None
    for n in range(1, tries + 1):
        before = sum(launches())
        with torch_profile(activities=[ProfilerActivity.CPU,
                                       ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        made = sum(launches()) - before
        dev, host = _read(prof)
        share = counted(dev) / made if made else 1.0
        if best is None or share > best[2]:
            best = (dev, host, share)
        if share >= min_share:
            break
    dev, host, share = best
    if not dev:
        raise RuntimeError("the profiler recorded no device operation")
    busy = sum(b - a for a, b in _union(dev)) * 1e-6
    ts = [e[1] for e in dev + host]
    te = [e[2] for e in dev + host]
    return Trace(kernels=dev, host=host, window_s=(max(te) - min(ts)) * 1e-6,
                 busy_s=busy, share=share, tries=n,
                 lossless=share >= min_share)


def busy_within(trace: Trace, name: str):
    """Seconds of the union of the device's intervals inside the host
    operations called `name` (a span the benchmark holds open, between two
    synchronizations, over the work it reads), or None where the trace
    has no such operation."""
    spans = [(a, b) for n, a, b in trace.host if n == name]
    if not spans:
        return None
    busy = 0.0
    for lo, hi in spans:
        inside = [(None, max(a, lo), min(b, hi)) for _, a, b in trace.kernels
                  if b > lo and a < hi]
        busy += sum(b - a for a, b in _union(inside))
    return busy * 1e-6


_TEMPLATE = re.compile(r"(spd_\w+_kernel)<(\d+)")


def spd_kernels(trace: Trace) -> dict:
    """{(kernel, N): (launches, seconds)} of the SPD kernels in the trace."""
    out = {}
    for name, (c, s) in trace.by_name().items():
        m = _TEMPLATE.search(name)
        if m:
            key = (m.group(1), int(m.group(2)))
            c0, s0 = out.get(key, (0, 0.0))
            out[key] = (c0 + c, s0 + s)
    return out


def seconds_of(trace: Trace, kernel: str) -> tuple[int, float]:
    """(launches, seconds) of the device operations that are launches of
    the kernel `kernel`: its whole name, followed by its template or
    argument list, as a profiler names it (`resident_ipm_kernel` is not
    `resident_ipm_qp_kernel`)."""
    whole = re.compile(rf"\b{re.escape(kernel)}\s*[<(]")
    c = s = 0
    for name, (n, t) in trace.by_name().items():
        if whole.search(name):
            c, s = c + n, s + t
    return c, s
