"""The closed loop's tick split out of the cycle, on the CPU.

runtime/loop.py runs a cycle's ticks through `_scan_ticks`: on the card as
replays of a captured CUDA graph of `_step` (runtime/graph.py), on the
CPU as eager ticks.  A replay writes the new carry into the graph's
static buffers and reads nothing the host computes between ticks, so
here: the tick's carry keeps its layout leaf by leaf, the trace written
by index equals the ticks' values stacked, and the captured code reads
nothing back to the host.  The graph's capture and replay need the card
(tests/test_torch_cuda.py); its tree handling is checked here.  The loop
itself is held to the JAX package by tests/test_torch_loop.py and
tests/test_torch_zoo_loop.py.
"""

import ast
import inspect
from pathlib import Path

import pytest
import torch

from apf_quadruped_tpu_torch.config import (EngineConfig, GaitConfig,
                                            MpcConfig, SimConfig,
                                            SolverConfig, WbcConfig)
from apf_quadruped_tpu_torch.ops import cuda_chol, cuda_qp, cuda_riccati
from apf_quadruped_tpu_torch.runtime import graph, loop
from apf_quadruped_tpu_torch.sim import disturbance, terrain

torch.set_num_threads(1)

F64 = torch.float64
B = 2
N_TICKS = 6


def _cfg(early_td=True):
    return EngineConfig(gait=GaitConfig(trot_cycle=N_TICKS * 0.0025,
                                        early_td=early_td),
                        mpc=MpcConfig(horizon=4, dt=0.025),
                        sim=SimConfig(substeps=1, terrain_res=16),
                        solver=SolverConfig(iters=4),
                        wbc=WbcConfig(slack_weight_trot=1e6))


def _world(cfg, name):
    kw = dict(batch=(B,), dtype=F64)
    return (terrain.flat(cfg.sim, **kw) if name == "flat"
            else terrain.block(cfg.sim, **kw))


def _inputs(world, early_td=True):
    """(cfg, cycle inputs, initial carry) of one cycle of the tiny loop,
    as run_cycle hands them to _scan_ticks."""
    cfg = _cfg(early_td)
    seen = {}
    real = loop._scan_ticks

    def spy(cfg_, cyc, carry, n):
        seen.update(cyc=cyc, carry=carry, n=n)
        return real(cfg_, cyc, carry, n)

    st = loop.init(cfg, B, dtype=F64, device="cpu")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(loop, "_scan_ticks", spy)
        loop.run_cycle(cfg, st, _world(cfg, world),
                       torch.tensor([[0.0, 1.0]] * B, dtype=F64),
                       disturbance.empty(F64)[None].expand(B, 1, 8))
    assert seen["n"] == N_TICKS
    return cfg, seen["cyc"], seen["carry"]


@pytest.fixture(scope="module", params=["flat", "block"])
def inputs(request):
    return _inputs(request.param)


def _k(i):
    return torch.tensor([i], dtype=torch.int64)


def test_tick_carry_keeps_its_layout(inputs):
    """The graph copies each new carry leaf into the buffer of the old one:
    every leaf keeps its shape, dtype and device, tick after tick."""
    cfg, cyc, carry = inputs
    layout = [(t.shape, t.dtype, t.device) for t in graph._tensors(carry)]
    assert len(layout) == 6 + 3 + 3 + 3   # SimState, ApfState, td, obs
    for i in range(3):
        carry, row = loop._tick(cfg, cyc, carry, _k(i))
        assert [(t.shape, t.dtype, t.device)
                for t in graph._tensors(carry)] == layout
    # on a height map the ground counts follow the flat tick's values
    assert [(v.shape, v.dtype) for v in row] == (
        [((B,), torch.bool)] * 2
        + [((B,), F64)] * (len(loop._trace_names(cyc.terr)) - 2))


def test_trace_is_the_ticks_stacked(inputs):
    """The eager scan's index-written trace equals the values of ticks run
    one by one, stacked; the final carries are equal too."""
    cfg, cyc, carry = inputs
    out, trace = loop._scan_ticks_eager(cfg, cyc, carry, N_TICKS)
    rows = []
    for i in range(N_TICKS):
        carry, row = loop._tick(cfg, cyc, carry, _k(i))
        rows.append(row)
    assert len(trace) == len(loop._trace_names(cyc.terr))
    assert len(trace) == len(loop.TRACE) + (
        len(loop.TRACE_GROUND) if cyc.terr.h_map is not None else 0)
    for j, buf in enumerate(trace):
        assert buf.shape == (B, N_TICKS)
        assert torch.equal(buf, torch.stack([r[j] for r in rows], dim=-1))
    for a, b in zip(graph._tensors(out), graph._tensors(carry)):
        assert torch.equal(a, b)


def test_tick_index_is_exact():
    """The tick's time and knot coordinate from the device index k equal
    those of the Python index the loop used before (k in float, times
    sim.dt or the knot ratio) at every tick of a 200-tick cycle."""
    dt, ratio = 0.0025, 0.1
    k = torch.arange(200, dtype=torch.int64)
    for dtype in (torch.float32, F64):
        for scale in (dt, ratio):
            old = torch.stack([torch.full((3,), i, dtype=dtype) * scale
                               for i in range(200)])
            new = torch.stack([(k[i:i + 1].to(dtype) * scale).expand(3)
                               for i in range(200)])
            assert torch.equal(old, new)

# calls that read a value back to the host or copy one from it: either
# stalls the eager tick, and neither can be captured
_HOST_ATTRS = {"item", "tolist", "cpu", "numpy"}
_HOST_NAMES = {"bool", "float", "int"}


def _host_reads(fn_node):
    for node in ast.walk(fn_node):
        if not isinstance(node, ast.Call):
            continue
        f = node.func
        if isinstance(f, ast.Attribute) and f.attr in _HOST_ATTRS:
            yield f"{f.attr}() at line {node.lineno}"
        if isinstance(f, ast.Name) and f.id in _HOST_NAMES:
            yield f"{f.id}() at line {node.lineno}"
        if (isinstance(f, ast.Attribute) and f.attr == "tensor"
                and isinstance(f.value, ast.Name) and f.value.id == "torch"):
            yield f"torch.tensor() at line {node.lineno}"


def test_captured_code_reads_nothing_back_to_host():
    """_step (what the graph captures), _tick and every function of
    loop.py they name hold no .item(), .tolist(), bool(), float(), int()
    or torch.tensor()."""
    tree = ast.parse(Path(inspect.getsourcefile(loop)).read_text())
    defs = {n.name: n for n in tree.body if isinstance(n, ast.FunctionDef)}
    todo, seen = ["_step"], set()
    while todo:
        name = todo.pop()
        if name in seen:
            continue
        seen.add(name)
        todo += [n.id for n in ast.walk(defs[name])
                 if isinstance(n, ast.Name) and n.id in defs]
    assert {"_step", "_tick", "_take"} <= seen
    found = {name: list(_host_reads(defs[name])) for name in seen}
    assert not any(found.values()), found


def test_cpu_cycle_takes_the_eager_ticks(monkeypatch):
    """CPU tensors never reach the graph."""
    def refuse(*args, **kw):
        raise AssertionError("graph.scan called on the CPU")

    monkeypatch.setattr(graph, "scan", refuse)
    cfg, cyc, carry = _inputs("flat", early_td=False)
    assert carry[0].q.device.type == "cpu"


def test_graph_scan_takes_cuda_tensors_only():
    cfg, cyc, carry = _inputs("flat", early_td=False)
    with pytest.raises(ValueError, match="CUDA graph"):
        graph.scan((cfg, N_TICKS), None, cyc, carry, (), N_TICKS)


def test_write_back_copies_new_leaves_and_keeps_passed_ones():
    a, b = torch.zeros(3), torch.ones(2, 2)
    dst = (a, (b,))
    new_a = torch.full((3,), 2.0)
    graph._write_back(dst, (new_a, (b,)))
    assert torch.equal(a, new_a) and dst[0] is a and torch.equal(
        b, torch.ones(2, 2))


@pytest.mark.parametrize("case", ["view", "shape", "dtype", "count"])
def test_write_back_refuses_what_it_cannot_copy(case):
    a, b = torch.zeros(3), torch.zeros(4)
    new = {"view": (torch.zeros(3), a.view(3)),
           "shape": (torch.zeros(3), torch.zeros(5)),
           "dtype": (torch.zeros(3), torch.zeros(4, dtype=F64)),
           "count": (torch.zeros(3),)}[case]
    with pytest.raises(ValueError):
        graph._write_back((a, b), new)


def test_signature_tells_layouts_apart():
    """A graph is keyed on every input's shape, strides and dtype and on
    whether the world has a height map: each branch of the tick that
    depends on them is part of the capture."""
    mu = torch.zeros(2, 4, 4)
    flat = terrain.Terrain(mu_map=mu, extent=1.0, res=4)
    high = flat._replace(h_map=torch.zeros(2, 4, 4))
    x = torch.zeros(2, 3)
    sig = graph._signature
    assert sig((flat, x)) == sig((flat._replace(mu_map=mu.clone()),
                                  x.clone()))
    assert sig(flat) != sig(high)
    assert sig(flat) != sig(flat._replace(extent=2.0))
    assert sig(x) != sig(torch.zeros(3, 3))
    assert sig(x) != sig(torch.zeros(3, 2).t())
    assert sig(x) != sig(x.to(F64))


def test_graph_counts_every_kernel_wrapper():
    """A replay adds each kernel's launches to its wrapper's counter:
    graph._counters holds every wrapper that counts."""
    counted = {f for mod in (cuda_chol, cuda_qp, cuda_riccati)
               for f in vars(mod).values() if hasattr(f, "launches")}
    assert set(graph._counters()) == counted
