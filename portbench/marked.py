"""The marked profile: the program's stage marks read from the device trace.

With `profiling.marks(True)` the program launches an empty kernel,
`apf_mark_kernel<ID>`, at each stage boundary of a tick, a WBC solve and a
Riccati plan (apf_quadruped_tpu_torch/runtime/profiling.py, whose STAGES
names the IDs).  A stage's interval runs from the end of its mark to the
start of the next mark; a unit (a tick, a WBC call, a plan) from the end
of its first stage's mark to the start of its end mark.  The metrics read
a stage's busy time, the union of the device operations inside its
interval: under the profiler every graph node costs the device about
0.5 us more, which the intervals carry and the busy times do not.

After a traced window's own profiles, which run with marks off as the
window does, `observe(obs)` runs one more profile of the same work with
marks on, after a replay that captures the marked graphs outside it, and
reads from it what the per-layer metrics `tick_*_device_ms.sweep`,
`wbc_qp_device_ms.realtime` and `plan_pack_device_ms.plan` report.  It
runs once a traced run; every reader of those metrics shares its result.
It prints a line of each stage's device ms and kernels a unit, and one of
the traced window's idle time by the program's span that held the host.
The window's results are on the host by then (the runner's `release`
comes after the readers, `check` reads only what the window kept), so the
marked graphs it captures touch no number compared.

Each traffic kind brings its own marked profile on its runner
(portbench/kinds/<kind>.py): `marked_work()`, the work to profile, called
with marks on, which returns a function that runs it; `marked_units`,
the units it holds, [(first stage, end mark)]; `marked_numbers(seen)`,
the metrics' values from `read_units`'s result.  A runner that defines
none of them gets no marked numbers.  The runner's `traced()` hands
itself to the readers under the key "runner" of its observations.  Where
the program has no marks (a tree from before them) or the marked profile
lost launches under the guard's 95% (portbench/trace.py), the readers
read nothing (None).  Where the program has marks and the observations
hold no runner, or the marked profile fails, the reader raises, so that
a traced run with missing metrics fails rather than leaves them out.
"""

from __future__ import annotations

import re
import sys

import numpy as np

from . import trace as trace_mod

MARK = re.compile(r"apf_mark_kernel<(\d+)>")
# the program's spans, and the benchmark's own (trace_mod.SPAN)
PROGRAM_SPAN = "apf: "


# -- the arithmetic on a trace ---------------------------------------------

class Ops:
    """Device operations as arrays of their intervals, in order of their
    start."""

    def __init__(self, ops):
        iv = np.array(sorted((a, b) for _, a, b in ops),
                      dtype=np.float64).reshape(-1, 2)
        self.start, self.end = iv[:, 0], iv[:, 1]
        self.longest = float((self.end - self.start).max()) if len(iv) else 0

    def count(self, lo, hi) -> int:
        """How many operations start in [lo, hi)."""
        return int(np.searchsorted(self.start, hi, "left")
                   - np.searchsorted(self.start, lo, "left"))

    def busy(self, lo, hi) -> float:
        """The union of the operations' intervals inside (lo, hi)."""
        i = np.searchsorted(self.start, lo - self.longest, "left")
        j = np.searchsorted(self.start, hi, "left")
        a = np.clip(self.start[i:j], lo, hi)
        b = np.clip(self.end[i:j], lo, hi)
        return sum(y - x for x, y in trace_mod._union(
            (None, x, y) for x, y in zip(a.tolist(), b.tolist()) if y > x))


def split(kernels, stages) -> tuple[list, Ops]:
    """([(stage, start, end)] of the marks, in order of their start; the
    other device operations).  `stages` names the IDs."""
    marks, others = [], []
    for name, a, b in kernels:
        m = MARK.search(name)
        if m is None:
            others.append((name, a, b))
        elif int(m.group(1)) < len(stages):
            marks.append((stages[int(m.group(1))], a, b))
    marks.sort(key=lambda x: x[1])
    return marks, Ops(others)


class Unit:
    """One marked unit: its interval (lo, hi) and its stages' intervals,
    [(stage, start, end)] in order."""

    def __init__(self, lo, hi, stages):
        self.lo, self.hi, self.stages = lo, hi, stages

    def busy_us(self, others: "Ops", keep) -> float:
        """The busy time of the stages for which `keep(stage)` holds: the
        union of `others` inside each stage's interval, summed."""
        return sum(others.busy(a, b) for s, a, b in self.stages if keep(s))


def units(marks, first: str, end: str) -> list[Unit]:
    """The units that open with a mark of `first` and close with a mark
    of `end`; marks outside them are left out, and so is a unit that is
    not closed or that another `first` opens again before its end."""
    out, cur = [], None
    for (s, a, b), nxt in zip(marks, marks[1:] + [None]):
        if s == first:
            cur = []
        if cur is None:
            continue
        if s == end:
            if cur:
                out.append(Unit(cur[0][1], a, cur))
            cur = None
        elif nxt is not None:
            cur.append((s, b, nxt[1]))
    return out


def stage_table(others: Ops, us) -> dict:
    """{stage: (mean ms a unit, mean busy ms a unit, mean kernels a unit)}
    over `us`: each stage's interval, the union of the device operations
    inside it, and the operations that start in it."""
    acc = {}
    for u in us:
        for s, a, b in u.stages:
            ms, busy, n = acc.get(s, (0.0, 0.0, 0))
            acc[s] = (ms + (b - a) * 1e-3, busy + others.busy(a, b) * 1e-3,
                      n + others.count(a, b))
    return {s: tuple(v / len(us) for v in vals) for s, vals in acc.items()}


def idle_by_span(trace, top: int = 6) -> list:
    """[(spans, seconds)] of the device's idle time by the spans of the
    program's (`apf: `) and the benchmark's (`portbench: `) that held the
    host at the middle of each gap, outermost to innermost (joined by
    " > "), the largest first."""
    spans = sorted(((n, a, b) for n, a, b in trace.host
                    if n.startswith((PROGRAM_SPAN, trace_mod.SPAN))),
                   key=lambda x: -(x[2] - x[1]))
    chains = [" > ".join([n for n, a, b in spans[:i]
                          if a <= lo and hi <= b] + [name])
              for i, (name, lo, hi) in enumerate(spans)]
    gaps = np.array(trace_mod._gaps(trace.kernels, trace._bounds()),
                    dtype=np.float64).reshape(-1, 2)
    mid = 0.5 * (gaps[:, 0] + gaps[:, 1])
    inner = np.full(len(gaps), -1)
    for i, (_, lo, hi) in enumerate(spans):     # the shortest last
        inner[(lo <= mid) & (mid <= hi)] = i
    out = {}
    for i, secs in zip(inner, (gaps[:, 1] - gaps[:, 0]) * 1e-6):
        name = chains[i] if i >= 0 else "no span"
        out[name] = out.get(name, 0.0) + float(secs)
    return sorted(out.items(), key=lambda x: -x[1])[:top]


def read_units(trace, keys, stages) -> dict:
    """What a kind's metrics read of a marked trace: {(first, end):
    [Unit]} for each (first stage, end mark) of `keys`, the operations
    that are not marks, and the marks."""
    marks, others = split(trace.kernels, stages)
    return {"units": {key: units(marks, *key) for key in keys},
            "others": others, "marks": marks}


def busy_ms(us, others: Ops, keep, mean=np.mean) -> float:
    """`mean` over the units `us` of the busy time of their stages for
    which `keep(stage)` holds, in ms."""
    return float(mean([u.busy_us(others, keep) for u in us])) * 1e-3


# -- the profile -------------------------------------------------------------

# (the observations last read, their numbers)
_last = (None, None)


def observe(obs) -> dict | None:
    """The marked profile's numbers for the traced window `obs` (run once,
    then shared), or None (module docstring)."""
    global _last
    if _last[0] is not obs:
        _last = (obs, _observe(obs))
    return _last[1]


def _observe(obs) -> dict | None:
    from apf_quadruped_tpu_torch.runtime import profiling
    if not hasattr(profiling, "marks"):
        return None
    rnr = obs.get("runner")
    if rnr is None:
        raise RuntimeError("the traced window's observations hold no runner "
                           "(the key \"runner\", which the kind's traced() "
                           "sets), so the marked profile cannot run")
    if not hasattr(rnr, "marked_work"):
        return None
    kind = obs.get("kind")
    if "trace" in obs:
        _print("idle by the span that held the host (the traced window's "
               "profile): " + ", ".join(f"{n} {s:.6f} s" for n, s
                                       in idle_by_span(obs["trace"])))
    with profiling.marks(True):
        work = rnr.marked_work()
        tr = trace_mod.profile(work, rnr.graph._counts)
    seen = read_units(tr, rnr.marked_units, profiling.STAGES)
    _notes(kind, tr, seen, obs)
    if not tr.lossless:
        _print("the marked profile recorded under the guard's 95% of the "
               "counted launches: its metrics are left out")
        return None
    return rnr.marked_numbers(seen)


def _print(line):
    print("portbench: " + line, file=sys.stderr, flush=True)


def _notes(kind, tr, seen, obs):
    others = seen["others"]
    for (first, end), us in seen["units"].items():
        if not us:
            continue
        table = stage_table(others, us)
        span = float(np.mean([u.hi - u.lo for u in us])) * 1e-3
        busy = float(np.mean([others.busy(u.lo, u.hi) for u in us])) * 1e-3
        _print(f"marked {kind} profile, {len(us)} units {first}..{end}: "
               f"unit {span:.4f} ms, busy {busy:.4f} ms, stages "
               + ", ".join(f"{s} {ms:.4f} ms (busy {b_ms:.4f}) / {n:.1f} "
                           f"kernels" for s, (ms, b_ms, n) in table.items())
               + f" (sum {sum(v[0] for v in table.values()):.4f} ms); "
               f"{len(seen['marks'])} marks; {tr.share:.2%} of the counted "
               f"launches recorded")
    for key in ("tick_device_ms", "wbc_device_ms", "replan_device_ms"):
        if obs.get(key) is not None:
            _print(f"unmarked {key} {obs[key]:.4f}")
