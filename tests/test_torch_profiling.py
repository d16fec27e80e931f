"""runtime/profiling.py of the port: spans reach torch.profiler and nest
as the closed loop's calls nest, and cost a shared null context where no
profiler records; stage marks are a no-op on the CPU and part of every
graph's key; `timed` times calls, the solver statistics of a plan equal
the JAX package's on the same problem, and the cross-process mean is the
identity without a process group.  On the card (tests/test_torch_cuda.py)
the marks' kernels, their graphs and the graph spans."""

import ast
import contextlib
import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apf_quadruped_tpu import planner as jplanner
from apf_quadruped_tpu.config import (EngineConfig as JEngineConfig,
                                      MpcConfig as JMpcConfig)
from apf_quadruped_tpu.runtime import profiling as jprofiling
from apf_quadruped_tpu_torch import _kernels, convert, planner, problems, wbc
from apf_quadruped_tpu_torch.config import (EngineConfig, GaitConfig,
                                            MpcConfig, SimConfig,
                                            SolverConfig)
from apf_quadruped_tpu_torch.runtime import graph, loop, profiling, sweep
from apf_quadruped_tpu_torch.sim import disturbance, terrain

torch.set_num_threads(1)


def test_trace_names_reach_the_profiler():
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with profiling.trace("apf_outer_region"):
            with profiling.trace("apf_inner_region"):
                torch.ones(64).cumsum(0)
    names = {e.key for e in prof.key_averages()}
    assert {"apf: apf_outer_region", "apf: apf_inner_region"} <= names


def test_trace_without_a_profiler_is_the_shared_null_context(monkeypatch):
    """No profiler records: every span is one shared null context, and
    nothing reaches the profiler's recorder."""
    def refuse(*args, **kw):
        raise AssertionError("record_function called with no profiler")

    monkeypatch.setattr(profiling.torch.profiler, "record_function", refuse)
    assert not torch.autograd._profiler_enabled()
    a, b = profiling.trace("loop.run_cycle"), profiling.trace("graph.call",
                                                              "wbc")
    assert a is b and isinstance(a, contextlib.nullcontext)
    with a, b:
        torch.ones(8).cumsum(0)


def _graph_phases():
    """graph._phases on three recording steps: (the result, the steps in
    the order they ran)."""
    ran = []

    def copy_in():
        ran.append("inputs")
        return 1

    def copy_out(x):
        ran.append("outputs")
        return x + 1
    out = graph._phases("call", "wbc", copy_in,
                        lambda x: ran.append(("replay", x)), copy_out)
    return out, ran


def test_graph_phases_without_a_profiler_open_no_span(monkeypatch):
    """No profiler records: a graph's call or scan runs its phases in
    order after one check, and opens no span, not even a null one."""
    def refuse(*args, **kw):
        raise AssertionError("a span opened with no profiler")

    monkeypatch.setattr(profiling, "trace", refuse)
    assert _graph_phases() == (2, ["inputs", ("replay", 1), "outputs"])


def test_graph_phases_under_a_profiler_are_nested_spans():
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        assert _graph_phases()[0] == 2
    spans = _spans(prof)
    assert [n for n, _, _ in spans] == ["apf: graph.call wbc", "apf: inputs",
                                        "apf: replay", "apf: outputs"]
    (_, lo, hi), parts = spans[0], spans[1:]
    for (_, a, b), (_, c, _) in zip(parts, parts[1:] + [(None, hi, 0)]):
        assert lo <= a <= b <= c <= hi


def test_trace_joins_its_parts():
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with profiling.trace("graph.call", "cycle head"):
            pass
    assert "apf: graph.call cycle head" in {e.key
                                            for e in prof.key_averages()}


# the tiny closed loop of tests/test_torch_tick.py
B, N_TICKS = 2, 3


def _tiny():
    cfg = EngineConfig(gait=GaitConfig(trot_cycle=N_TICKS * 0.0025),
                       mpc=MpcConfig(horizon=4, dt=0.025),
                       sim=SimConfig(substeps=1, terrain_res=16),
                       solver=SolverConfig(iters=4))
    F64 = torch.float64
    st = loop.init(cfg, B, dtype=F64, device="cpu")
    args = (terrain.flat(cfg.sim, batch=(B,), dtype=F64),
            torch.tensor([[0.0, 1.0]] * B, dtype=F64),
            disturbance.empty(F64)[None].expand(B, 1, 8))
    return cfg, st, args


def _spans(prof, prefix=profiling.PREFIX):
    """[(name, start, end)] of the host spans named `prefix...`, in order
    of their start."""
    out = [(e.name, e.time_range.start, e.time_range.end)
           for e in prof.events() if e.name.startswith(prefix)]
    return sorted(out, key=lambda x: (x[1], -x[2]))


def test_cycle_spans_nest_in_order():
    """One eager cycle at B=2 under a profiler: `apf: loop.run_cycle`
    holds its head, its ticks and its tail, one each, in that order."""
    cfg, st, args = _tiny()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        loop.run_cycle(cfg, st, *args)
    spans = _spans(prof, "apf: loop.")
    names = [n for n, _, _ in spans]
    assert names == ["apf: loop.run_cycle", "apf: loop.cycle_head",
                     "apf: loop.scan_ticks", "apf: loop.cycle_tail"]
    (_, lo, hi), children = spans[0], spans[1:]
    for (_, a, b), (_, c, _) in zip(children, children[1:] + [(None, hi, 0)]):
        assert lo <= a <= b <= c <= hi


def test_step_batch_span_holds_its_cycles(monkeypatch):
    """`apf: sweep.step_batch` holds each cycle's `apf: loop.run_cycle`."""
    cfg, st, (terr, target, dist) = _tiny()
    monkeypatch.setattr(sweep, "_terrain", lambda cfg, scn: terr)
    scn = sweep.Scenario(mu_map=None, target_xy=target, dist_sched=dist,
                         spawn_xy=None, spawn_yaw=None)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        sweep.step_batch(cfg, scn, st, 2)
    spans = _spans(prof, "apf: ")
    outer = [s for s in spans if s[0] == "apf: sweep.step_batch"]
    cycles = [s for s in spans if s[0] == "apf: loop.run_cycle"]
    assert len(outer) == 1 and len(cycles) == 2
    assert all(outer[0][1] <= a <= b <= outer[0][2] for _, a, b in cycles)


def test_marks_are_a_no_op_on_the_cpu(monkeypatch):
    """With marks on, a CPU cycle loads no library and equals the cycle
    without marks bit for bit."""
    def refuse(*args, **kw):
        raise AssertionError("the marks' library loaded on the CPU")

    monkeypatch.setattr(_kernels, "apf_mark", refuse)
    cfg, st, args = _tiny()
    plain = loop.run_cycle(cfg, st, *args)
    with profiling.marks(True):
        assert profiling.marks_on()
        marked = loop.run_cycle(cfg, st, *args)
    assert not profiling.marks_on()
    a, b = graph._tensors(plain), graph._tensors(marked)
    assert len(a) == len(b) and all(torch.equal(x, y) for x, y in zip(a, b))


def test_marks_switch_nests_and_restores():
    assert not profiling.marks_on()
    with pytest.raises(RuntimeError):
        with profiling.marks(True):
            with profiling.marks(False):
                assert not profiling.marks_on()
            assert profiling.marks_on()
            raise RuntimeError("left through an error")
    assert not profiling.marks_on()


def test_marks_on_a_card_load_the_library_first(monkeypatch):
    """On a machine with a card, turning marks on builds and loads the
    marks' library before any graph is captured with them."""
    loaded = []
    monkeypatch.setattr(profiling.torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(_kernels, "apf_mark", lambda: loaded.append(1))
    with profiling.marks(True):
        pass
    with profiling.marks(False):
        pass
    assert loaded == [1]


def test_marks_change_the_graph_key():
    """A graph captured with marks never serves a call without them: the
    cache's key holds the switch, and nothing else of it moves."""
    x = torch.zeros(2, 3)
    dev = torch.device("cuda", 0)
    off = graph._full_key("call", ("wbc", 1), dev, (x,))
    with profiling.marks(True):
        on = graph._full_key("call", ("wbc", 1), dev, (x,))
        assert on == graph._full_key("call", ("wbc", 1), dev, (x,))
        scan_on = graph._full_key("scan", ("tick", 1), dev, (x,), (x,), ())
    assert on != off and hash(on) != hash(off)
    assert [v for v in on if v is not True] == [v for v in off
                                                if v is not False]
    assert scan_on != graph._full_key("scan", ("tick", 1), dev, (x,), (x,),
                                      ())


@pytest.mark.parametrize("module", [loop, wbc, planner])
def test_every_mark_names_a_stage(module):
    """Each `profiling.mark(...)` of the marked modules names one of
    STAGES; an unknown stage raises even with marks off."""
    tree = ast.parse(inspect.getsource(module))
    names = [n.args[0].value for n in ast.walk(tree)
             if isinstance(n, ast.Call) and isinstance(n.func, ast.Attribute)
             and n.func.attr == "mark"
             and isinstance(n.func.value, ast.Name)
             and n.func.value.id == "profiling"]
    assert names and set(names) <= set(profiling.STAGES)
    with pytest.raises(KeyError):
        profiling.mark("no.such.stage", torch.zeros(1))


def test_stages_fit_the_marks_library():
    src = (_kernels.CSRC / "apf_mark.cu").read_text()
    count = int(src.split("constexpr int MARK_COUNT = ")[1].split(";")[0])
    assert len(profiling.STAGES) <= count
    assert len(set(profiling.STAGES)) == len(profiling.STAGES)


def test_timed_counts_its_calls():
    calls = []

    def fn(x, k=1):
        calls.append(k)
        return x * k

    out, secs = profiling.timed(fn, torch.ones(3), reps=4, k=2)
    assert torch.equal(out, torch.full((3,), 2.0))
    assert len(calls) == 5 and secs >= 0.0
    profiling.timed(fn, torch.ones(3), reps=2, warmup=False)
    assert len(calls) == 7


def test_solver_stats_match_jax():
    cfg = EngineConfig(mpc=MpcConfig(horizon=6, dt=0.025, backend="riccati"))
    x0, refs = problems.bench_problem(cfg, 16, device="cpu")
    jcfg = JEngineConfig(mpc=JMpcConfig(horizon=6, dt=0.025,
                                        backend="riccati"))
    jrefs = jplanner.MpcRefs(**{k: None if v is None else jnp.asarray(v)
                                for k, v in convert.to_numpy(refs)
                                ._asdict().items()})
    jout = jplanner.plan(jcfg, jnp.asarray(x0.numpy()), jrefs)
    stats = profiling.SolverStats.collect(planner.plan(cfg, x0, refs).sol)
    jstats = jprofiling.SolverStats.collect(jout.sol)
    assert stats.conv_frac == jstats.conv_frac
    assert stats.iters_p50 == jstats.iters_p50
    assert stats.iters_p99 == jstats.iters_p99
    np.testing.assert_allclose([stats.gap_max, stats.res_max],
                               [jstats.gap_max, jstats.res_max], rtol=1e-3)
    assert set(stats.as_dict()) == set(jstats.as_dict())


def test_pmean_stats_without_a_group_is_the_identity():
    import torch.distributed as dist

    assert not dist.is_initialized()
    stats = {"goal_dist": torch.tensor(1.5), "fell": 0.25}
    assert profiling.pmean_stats(stats) is stats


@pytest.mark.parametrize("reps", [1, 3])
def test_timed_fences_card_outputs(reps, monkeypatch):
    """On a CUDA output `timed` synchronizes (here a stand-in records the
    call): once after the warm-up, once after the timed calls."""
    synced = []
    monkeypatch.setattr(profiling.torch.cuda, "synchronize",
                        lambda: synced.append(1))
    monkeypatch.setattr(profiling, "_on_cuda", lambda out: True)
    profiling.timed(lambda: torch.ones(1), reps=reps)
    assert len(synced) == 2
