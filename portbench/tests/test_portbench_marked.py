"""The marked profile's arithmetic (portbench/marked.py) on hand-made
traces: each stage's interval and busy time, and the plan's packing, as
each kind's runner reads them; the four readers' values through the
harness's path, None where there is nothing to read (no observations, no
marks, a lossy profile, a program without marks), and a failure where the
program has marks and the runner or the profile is missing; the runner
handed to the readers in its traced window's observations, with or
without the harness; and the program's spans kept off the device's
operations."""

from __future__ import annotations

import importlib
import types

import pytest
import torch

from apf_quadruped_tpu_torch.runtime import profiling
from portbench import harness, marked, spec, trace
from portbench.kinds import plan, realtime, sweep

STAGES = profiling.STAGES


def _mark(stage, a):
    """A mark of `stage` 1 us long from `a`, named as a trace names it."""
    return (f"void apf_mark_kernel<{STAGES.index(stage)}>()", a, a + 1.0)


def _tick(t0, qp_end=30.0):
    """One tick from t0 (us): each stage's mark, then its kernels; the
    QP's two kernels leave a 2 us gap; the carry's write-back after the
    end mark lies outside the tick."""
    k = [_mark("tick.refs", t0), ("refs", t0 + 2, t0 + 5),
         _mark("wbc.build", t0 + 6), ("build", t0 + 7, t0 + 10),
         _mark("wbc.qp", t0 + 11), ("qp_a", t0 + 12, t0 + 20),
         ("qp_b", t0 + 22, t0 + qp_end),
         _mark("wbc.torque", t0 + qp_end), ("torque", t0 + qp_end + 1,
                                            t0 + qp_end + 3),
         _mark("wbc.end", t0 + qp_end + 3), _mark("physics", t0 + qp_end + 4),
         ("physics", t0 + qp_end + 5, t0 + qp_end + 15),
         _mark("tick.tail", t0 + qp_end + 15),
         ("tail", t0 + qp_end + 16, t0 + qp_end + 20),
         _mark("tick.end", t0 + qp_end + 20),
         ("write back", t0 + qp_end + 22, t0 + qp_end + 23)]
    return k


def _head(t0):
    """A cycle head's plan: its marks are no tick's."""
    return [_mark("plan.pack", t0), ("lin", t0 + 1, t0 + 4),
            _mark("plan.ipm", t0 + 4), ("ipm", t0 + 5, t0 + 40),
            _mark("plan.unpack", t0 + 40), _mark("plan.end", t0 + 42)]


def _wbc_call(t0, qp_us):
    return [_mark("wbc.build", t0), ("build", t0 + 1, t0 + 3),
            _mark("wbc.qp", t0 + 4), ("qp", t0 + 5, t0 + 5 + qp_us),
            _mark("wbc.torque", t0 + 6 + qp_us),
            ("torque", t0 + 7 + qp_us, t0 + 8 + qp_us),
            _mark("wbc.end", t0 + 9 + qp_us)]


def _plan(t0):
    return [_mark("plan.pack", t0), ("lin", t0 + 1, t0 + 5),
            _mark("plan.ipm", t0 + 6), ("resident_ipm_kernel", t0 + 7,
                                        t0 + 100),
            _mark("plan.unpack", t0 + 100), ("copy", t0 + 101, t0 + 103),
            _mark("plan.end", t0 + 104)]


SWEEP = _head(0.0) + _tick(100.0) + _tick(200.0, qp_end=40.0)
REALTIME = _plan(0.0) + _wbc_call(200.0, 10.0) + _wbc_call(300.0, 20.0) \
    + _wbc_call(400.0, 40.0)
PLAN = _plan(0.0) + _plan(200.0)


def _trace(kernels, share=1.0, host=()):
    return trace.Trace(kernels=list(kernels), host=list(host), window_s=1.0,
                       busy_s=0.5, share=share, tries=1,
                       lossless=share >= 0.95)


def test_stage_intervals_and_busy_times_of_ticks():
    seen = marked.read_units(_trace(SWEEP), sweep.Runner.marked_units,
                             STAGES)
    ticks = seen["units"][("tick.refs", "tick.end")]
    assert len(ticks) == 2
    u = ticks[0]
    # from the end of the tick.refs mark to the start of the tick.end mark
    assert (u.lo, u.hi) == (101.0, 150.0)
    assert [s for s, _, _ in u.stages] == list(STAGES[:7])
    assert [b - a for _, a, b in u.stages] == [5, 4, 18, 2, 0, 10, 4]
    # the stages sum to the unit less the marks inside it (6 of 1 us)
    assert sum(b - a for _, a, b in u.stages) == (u.hi - u.lo) - 6
    assert seen["others"].busy(u.lo, u.hi) == 3 + 3 + 8 + 8 + 2 + 10 + 4
    out = sweep.Runner.marked_numbers(seen)
    # the QP stage's busy time: its two kernels, not the 2 us between them
    assert out["tick_qp_ms"] == pytest.approx((16 + 26) / 2 * 1e-3)
    assert out["tick_physics_ms"] == pytest.approx(10e-3)
    assert set(out) == {"tick_qp_ms", "tick_physics_ms"}
    table = marked.stage_table(seen["others"], ticks)
    assert table["wbc.qp"] == (pytest.approx(23e-3), pytest.approx(21e-3),
                               2.0)
    assert table["physics"] == (pytest.approx(10e-3), pytest.approx(10e-3),
                                1.0)


def test_wbc_calls_and_plans():
    seen = marked.read_units(_trace(REALTIME), realtime.Runner.marked_units,
                             STAGES)
    calls = seen["units"][("wbc.build", "wbc.end")]
    assert len(calls) == 3 and len(seen["units"][("plan.pack",
                                                  "plan.end")]) == 1
    out = realtime.Runner.marked_numbers(seen)
    # the median call's QP stage runs from the end of its mark (+5) to
    # the start of the torque mark (+6 + 20); its kernel is busy 20 us
    assert out == {"wbc_qp_ms": pytest.approx(20e-3)}
    assert calls[1].stages[1][2] - calls[1].stages[1][1] == 21
    packed = plan.Runner.marked_numbers(marked.read_units(
        _trace(PLAN), plan.Runner.marked_units, STAGES))
    # pack 1 -> 6 busy 4 us and unpack 101 -> 104 busy 2 us: the solver's
    # stage left out
    assert packed["plan_pack_ms"] == pytest.approx(6e-3)


def test_unclosed_and_reopened_units_are_left_out():
    tick = _tick(0.0)
    cut = tick[:-2]                       # no tick.end
    marks, _ = marked.split(cut + _tick(100.0), STAGES)
    assert len(marked.units(marks, "tick.refs", "tick.end")) == 1
    marks, _ = marked.split(tick[:5], STAGES)
    assert marked.units(marks, "tick.refs", "tick.end") == []


def test_busy_merges_overlaps_and_clips():
    ops = marked.Ops([("a", 0.0, 10.0), ("b", 5.0, 12.0), ("c", 20.0, 30.0),
                      ("d", 25.0, 26.0), ("e", 40.0, 50.0)])
    assert ops.busy(0.0, 100.0) == 12 + 10 + 10
    assert ops.busy(8.0, 45.0) == 4 + 10 + 5
    assert ops.busy(13.0, 19.0) == 0.0
    assert ops.count(0.0, 25.0) == 3


def test_idle_by_span_names_the_spans_that_held_the_host():
    kernels = [("k", 0.0, 10.0), ("k", 30.0, 40.0), ("k", 45.0, 50.0)]
    host = [("portbench: wbc.solve", 5.0, 48.0),
            ("apf: graph.call wbc", 8.0, 47.0),
            ("apf: replay", 12.0, 29.0), ("cudaGraphLaunch", 13.0, 28.0)]
    out = dict(marked.idle_by_span(_trace(kernels, host=host)))
    assert out == {
        "portbench: wbc.solve > apf: graph.call wbc > apf: replay":
            pytest.approx(20e-6),
        "portbench: wbc.solve > apf: graph.call wbc": pytest.approx(5e-6)}


# -- the readers, through the harness's path ---------------------------------

READERS = {"tick_qp_device_ms.sweep": ("sweep", SWEEP, 21e-3),
           "tick_physics_device_ms.sweep": ("sweep", SWEEP, 10e-3),
           "wbc_qp_device_ms.realtime": ("realtime", REALTIME, 20e-3),
           "plan_pack_device_ms.plan": ("plan", PLAN, 6e-3)}


def _runner(kind):
    """A runner of `kind` as the marked profile reads it: the kind's own
    units and numbers, its work a no-op, no set-up and no program behind
    it."""
    cls = importlib.import_module(f"portbench.kinds.{kind}").Runner
    rnr = cls.__new__(cls)
    rnr.graph = types.SimpleNamespace(_counts=lambda: (0,))
    rnr.marked_work = lambda: (lambda: None)
    return rnr


def _execute(read, obs, rnr):
    """What a kind's traced() hands the readers: its observations with
    the runner in them."""
    obs["runner"] = rnr
    return read(obs)


@pytest.fixture
def profiled(monkeypatch):
    """The marked profile replaced by a hand-made trace; its work a
    no-op.  Returns a list the profiles are counted in."""
    made = []

    def use(kernels, share=1.0):
        def profile(fn, launches):
            fn()
            made.append(1)
            return _trace(kernels, share)
        monkeypatch.setattr(marked.trace_mod, "profile", profile)
    use.made = made
    return use


@pytest.mark.parametrize("name", list(READERS))
def test_reader_reads_the_marked_profile(profiled, name):
    kind, kernels, value = READERS[name]
    profiled(kernels)
    read = spec.reader(name)
    obs = {"kind": kind}
    assert _execute(read, obs, _runner(kind)) == pytest.approx(value)
    assert read({}) is None
    other = {"sweep": "plan", "realtime": "sweep", "plan": "realtime"}[kind]
    assert _execute(read, {"kind": other}, _runner(other)) is None


@pytest.mark.parametrize("name", list(READERS))
def test_reader_reads_nothing_without_marks_or_guard(profiled, name,
                                                     monkeypatch):
    kind, kernels, _ = READERS[name]
    read = spec.reader(name)
    plain = [k for k in kernels if "apf_mark_kernel" not in k[0]]
    profiled(plain)
    assert _execute(read, {"kind": kind}, _runner(kind)) is None  # no marks
    profiled(kernels, share=0.9)
    assert _execute(read, {"kind": kind}, _runner(kind)) is None  # lossy
    profiled(kernels)
    monkeypatch.delattr(profiling, "marks")      # a program before marks
    assert _execute(read, {"kind": kind}, _runner(kind)) is None


def test_one_profile_serves_every_reader(profiled):
    profiled(SWEEP)
    obs = {"kind": "sweep"}
    rnr = _runner("sweep")
    for name in ("tick_qp_device_ms.sweep", "tick_physics_device_ms.sweep"):
        assert _execute(spec.reader(name), obs, rnr) is not None
    assert len(profiled.made) == 1


@pytest.mark.parametrize("name", list(READERS))
def test_reader_raises_without_runner(profiled, name):
    """With marks in the program, a reader whose observations hold no
    runner fails the run instead of leaving its metric out."""
    kind, kernels, _ = READERS[name]
    profiled(kernels)
    with pytest.raises(RuntimeError, match="runner"):
        spec.reader(name)({"kind": kind})


def test_a_failed_profile_raises():
    def broken():
        raise RuntimeError("no card")
    rnr = _runner("plan")
    rnr.marked_work = broken
    read = spec.reader("plan_pack_device_ms.plan")
    with pytest.raises(RuntimeError, match="no card"):
        _execute(read, {"kind": "plan"}, rnr)


class _Cell(plan.Runner):
    """A plan cell's runner whose window and traced window are made by
    hand: what harness.execute calls of it; its marked profile the plan
    kind's, its work a no-op."""

    captured_in_window = 0
    graph = types.SimpleNamespace(_counts=lambda: (0,))

    def __init__(self):
        pass

    def marked_work(self):
        return lambda: None

    def traffic(self):
        pass

    def warm(self):
        pass

    def window(self):
        return {"plan_solves_per_s": 1.0}

    def traced(self):
        host = [("portbench: planner.plan", 0.0, 110.0)]
        return {"kind": "plan", "runner": self,
                "trace": _trace(PLAN, host=host)}

    def counts(self):
        return 1, 0

    def release(self):
        pass

    def check(self):
        return {}


def test_the_harness_hands_the_readers_its_runner(profiled, monkeypatch):
    """Through harness.execute, the runner its traced() hands the readers
    in the observations runs the marked profile: a kind that stops
    handing it fails this test, and a traced run, instead of silently
    dropping the metrics."""
    profiled(PLAN)
    monkeypatch.setattr(harness.common, "forbidden_modules", lambda: [])
    cell = spec.cell("dogbot_trot.plan_b2048")
    cell = cell._replace(limits={}, per_layer=[
        m for m in cell.per_layer if m["name"] == "plan_pack_device_ms.plan"])
    run = harness.Run(cell=cell, seed=1, seconds=0.0, trace=True,
                      device=torch.device("cpu"))
    result, _ = harness.execute(run, _Cell())
    assert result["metrics"] == {"plan_pack_device_ms.plan": {
        "value": pytest.approx(6e-3), "unit": "ms"}}
    assert profiled.made == [1]


def test_a_reader_finds_the_runner_with_no_harness_frame(profiled):
    """The runner travels in the observations, not in a caller's frame:
    a reader called on a traced window's observations alone runs its
    kind's marked profile."""
    profiled(PLAN)
    obs = _Cell().traced()
    assert spec.reader("plan_pack_device_ms.plan")(obs) == pytest.approx(
        6e-3)
    assert profiled.made == [1] and not hasattr(marked, "_runner")


# -- the program's spans are not device operations ---------------------------

def _event(name, a, b, cuda, annotation=False):
    ev = types.SimpleNamespace(
        name=name, time_range=types.SimpleNamespace(start=a, end=b),
        device_type=(torch.autograd.DeviceType.CUDA if cuda
                     else torch.autograd.DeviceType.CPU))
    if annotation:
        ev.is_user_annotation = True
    return ev


def test_program_span_mirrors_are_not_device_operations():
    """A `record_function` span is mirrored on the device's timeline over
    the kernels it launched: the reader keeps the kernel and the host span
    and drops the mirror, so idle shares and busy times stay the
    device's."""
    prof = types.SimpleNamespace(events=lambda: [
        _event("apf: graph.call wbc", 0.0, 100.0, cuda=False,
               annotation=True),
        _event("apf: graph.call wbc", 10.0, 90.0, cuda=True,
               annotation=True),
        _event("portbench: wbc.solve", 10.0, 90.0, cuda=True),
        _event("spd_sub_rows_kernel<30>", 20.0, 30.0, cuda=True)])
    dev, host = trace._read(prof)
    assert dev == [("spd_sub_rows_kernel<30>", 20.0, 30.0)]
    assert host == [("apf: graph.call wbc", 0.0, 100.0)]
