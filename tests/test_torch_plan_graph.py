"""What lets planner.plan and the cycle's head be captured, on the CPU.

On the card `planner.plan` and `loop._cycle_head` replay captured CUDA
graphs (runtime/graph.call).  A capture cannot hold a copy from host
memory or a read back to the host, so the constants they read are built
once per (cfg, dtype, device) and a second plan or head builds no tensor
from host data.  Here: each cached constant equals the one the code built
on every call before, bit for bit, for every option; after a first plan
and a first head, a second of each calls neither torch.tensor nor
torch.as_tensor; CPU tensors never reach the graph, and graph.call
refuses them.  The capture and replay themselves need the card
(tests/test_torch_cuda.py, chip_smoke.py phase 21); the CPU plan and loop
are held to the JAX package by tests/test_torch_planner.py and
tests/test_torch_loop.py.
"""

import dataclasses

import numpy as np
import pytest
import torch

from apf_quadruped_tpu_torch import _device, apf, planner, problems
from apf_quadruped_tpu_torch.config import (EngineConfig, GaitConfig,
                                            MpcConfig, SimConfig,
                                            SolverConfig)
from apf_quadruped_tpu_torch.models import srb, zoo
from apf_quadruped_tpu_torch.ops import riccati as tr
from apf_quadruped_tpu_torch.runtime import graph, loop
from apf_quadruped_tpu_torch.sim import disturbance, terrain

torch.set_num_threads(1)

CPU = torch.device("cpu")
DTYPES = [torch.float32, torch.float64]
B, H = 3, 4

# every option of the plan path: (backend, MpcConfig fields, SolverConfig
# fields)
OPTIONS = {
    "resident": ("riccati_resident", {}, {}),
    "fused": ("riccati_fused", {}, {}),
    "scan": ("riccati", {}, {}),
    "use_pallas": ("riccati", {}, dict(use_pallas=True)),
    "condensed": ("condensed", {}, {}),
    "base_box+base_acc": ("riccati_resident",
                          dict(base_box=True, base_acc=True), {}),
    "fused base_box reroute": ("riccati_fused", dict(base_box=True), {}),
    "sqp_iters=2": ("riccati_resident", dict(sqp_iters=2), {}),
    "stage_bf16 resident": ("riccati_resident", {}, dict(stage_bf16=True)),
    "stage_bf16 fused": ("riccati_fused", {}, dict(stage_bf16=True)),
}


def _cfg(option, **mpc_extra):
    backend, mpc, solver = OPTIONS[option]
    return EngineConfig(mpc=MpcConfig(horizon=H, dt=0.025, backend=backend,
                                      **(mpc | mpc_extra)),
                        solver=SolverConfig(iters=4, **solver))


def _bitwise(a, b):
    return a.dtype == b.dtype and a.shape == b.shape and torch.equal(a, b)


# ---------------------------------------------------------------------------
# each cached constant against the one built the old way
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("robot", ["dogbot", "anymal", "hyq"])
def test_planner_constants_equal_the_old_ones(dtype, robot):
    base = (EngineConfig() if robot == "dogbot"
            else zoo.engine_config_for(robot))
    cfg = base.replace(mpc=dataclasses.replace(
        base.mpc, horizon=H, base_box=True, base_acc=True))
    mpc = cfg.mpc
    opts = dict(dtype=dtype, device=CPU)
    assert _bitwise(planner._mpc_costs(cfg, dtype, CPU), torch.tensor(
        [mpc.w_att] * 3 + [mpc.w_pos] * 3 + [mpc.w_omega] * 3
        + [mpc.w_vel] * 3 + [0.0], **opts))
    blk, rhs = planner._pyramid_constants(cfg)
    G, h = planner._pyramid_tensors(cfg, dtype, CPU)
    assert _bitwise(G, torch.as_tensor(blk, **opts))
    assert _bitwise(h, torch.as_tensor(rhs, **opts))
    Gk, hk = planner._condensed_pyramid(cfg, dtype, CPU)
    assert _bitwise(Gk, torch.as_tensor(np.kron(np.eye(H), blk), **opts))
    assert _bitwise(hk, torch.as_tensor(np.tile(rhs, H), **opts))
    Cx = np.zeros((6, srb.NX))
    for i, d in enumerate((0, 1, 5)):
        Cx[i, d] = 1.0
        Cx[3 + i, d] = -1.0
    assert _bitwise(planner._base_box_rows(dtype, CPU),
                    torch.as_tensor(Cx, **opts))
    assert _bitwise(_device.constant(mpc.base_dev_rad, dtype, CPU),
                    torch.tensor(mpc.base_dev_rad, **opts))
    assert _bitwise(planner._acc_rhs(cfg, dtype, CPU), torch.tensor(
        [mpc.acc_ang_max] * 3 + [mpc.acc_lin_max] * 3, **opts) * mpc.dt)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("robot", ["dogbot", "anymal", "hyq"])
def test_model_and_loop_constants_equal_the_old_ones(dtype, robot):
    cfg = (EngineConfig() if robot == "dogbot"
           else zoo.engine_config_for(robot))
    rc = cfg.robot
    opts = dict(dtype=dtype, device=CPU)
    ixx, iyy, izz, ixy, ixz, iyz = rc.inertia
    I_b = np.array([[ixx, ixy, ixz], [ixy, iyy, iyz], [ixz, iyz, izz]],
                   np.float64)
    assert _bitwise(srb._body_inertia_inv(rc, dtype, CPU),
                    torch.as_tensor(np.linalg.inv(I_b), **opts))
    assert _bitwise(_device.constant(rc.inertia, dtype, CPU),
                    torch.as_tensor(rc.inertia, **opts))
    assert _bitwise(_device.constant(cfg.mpc.dt, dtype, CPU),
                    torch.tensor(cfg.mpc.dt, **opts))
    g = torch.tensor([0.0, 0.0, -srb.GRAVITY], **opts)
    assert _bitwise(_device.constant((0.0, 0.0, -srb.GRAVITY), dtype, CPU),
                    g)
    assert _bitwise(_device.constant(tuple(rc.max_dev[:2]), dtype, CPU),
                    torch.tensor(rc.max_dev[:2], **opts))
    assert _bitwise(_device.constant((1.0, 0.0), dtype, CPU),
                    torch.tensor([1.0, 0.0], **opts))
    sol = cfg.solver
    for v in (sol.static_reg, sol.frac_to_boundary, 1.0, sol.warm_floor):
        assert _bitwise(_device.constant(v, dtype, CPU),
                        torch.as_tensor(v, **opts))


@pytest.mark.parametrize("dtype", DTYPES)
def test_device_indices_select_as_the_lists_did(dtype):
    """The trot pair's leg swap and the base_box dims, as device indices."""
    v = torch.randn(B, H, 4, 6, dtype=dtype)
    legs = _device.constant((1, 0, 3, 2), torch.int64, CPU)
    assert _bitwise(v.index_select(2, legs), v[:, :, [1, 0, 3, 2], :])
    assert _bitwise(v.index_select(3, _device.constant((0, 1, 5),
                                                       torch.int64, CPU)),
                    v[..., [0, 1, 5]])


@pytest.mark.parametrize("dtype", DTYPES)
def test_srb_derivative_solve_ex_equals_solve(dtype):
    """solve_ex without its check gives linalg.solve's bits (the
    derivative of sqp_iters > 1)."""
    gen = torch.Generator().manual_seed(0)
    M = torch.randn(64, 3, 3, generator=gen, dtype=dtype)
    I_w = M @ M.transpose(-1, -2) + torch.eye(3, dtype=dtype)
    rhs = torch.randn(64, 3, 1, generator=gen, dtype=dtype)
    assert _bitwise(torch.linalg.solve_ex(I_w, rhs, check_errors=False)[0],
                    torch.linalg.solve(I_w, rhs))


# ---------------------------------------------------------------------------
# a second plan and a second head build nothing from host data
# ---------------------------------------------------------------------------

def _count_host_builds(monkeypatch):
    """Count torch.tensor and torch.as_tensor calls from here on."""
    calls = []
    for name in ("tensor", "as_tensor"):
        real = getattr(torch, name)

        def counted(*a, _real=real, _name=name, **k):
            calls.append(_name)
            return _real(*a, **k)
        monkeypatch.setattr(torch, name, counted)
    return calls


def _plan_inputs(cfg, seed):
    x0, refs = problems.bench_problem(cfg, B, seed=seed, device="cpu",
                                      dtype=torch.float64)
    warm = tr.WarmStart(
        u=torch.zeros(B, H, 12, dtype=torch.float64),
        z=torch.ones(B, H, 24 + 12 * cfg.mpc.base_acc, dtype=torch.float64),
        s=torch.ones(B, H, 24 + 12 * cfg.mpc.base_acc, dtype=torch.float64),
        valid=torch.tensor([True, False, True]))
    return x0, refs, warm


@pytest.mark.parametrize("option", list(OPTIONS))
def test_second_plan_builds_nothing_from_host(monkeypatch, option):
    cfg = _cfg(option)
    first = _plan_inputs(cfg, 0)
    second = _plan_inputs(cfg, 1)
    planner.plan(cfg, *first)
    calls = _count_host_builds(monkeypatch)
    out = planner.plan(cfg, *second)
    assert calls == []
    assert bool(torch.isfinite(out.forces).all())


def _head_args(cfg, world):
    st = loop.init(cfg, B, dtype=torch.float64, device="cpu")
    kw = dict(batch=(B,), dtype=torch.float64)
    terr = (terrain.flat(cfg.sim, **kw) if world == "flat"
            else terrain.block(cfg.sim, **kw))
    tgt = torch.tensor([[0.0, 1.0]] * B, dtype=torch.float64)
    dist = disturbance.empty(torch.float64)[None].expand(B, 1, 8)
    return st, terr, tgt, dist


@pytest.mark.parametrize("option,world,mode", [
    ("resident", "flat", "trot"), ("resident", "block", "trot"),
    ("resident", "flat", "crawl"), ("resident", "flat", "adaptive"),
    ("fused", "flat", "trot"), ("scan", "block", "trot"),
    ("base_box+base_acc", "flat", "trot"), ("sqp_iters=2", "flat", "trot"),
    ("stage_bf16 resident", "flat", "trot"), ("condensed", "flat", "trot")])
def test_second_cycle_head_builds_nothing_from_host(monkeypatch, option,
                                                    world, mode):
    """The head of a cycle after the first: navigation, foothold,
    references, the plan (warm from the first cycle's stash) and the
    stash; height worlds add the cone bases."""
    cfg = _cfg(option).replace(gait=GaitConfig(mode=mode),
                               sim=SimConfig(terrain_res=16))
    st, terr, tgt, dist = _head_args(cfg, world)
    head = loop._cycle_head(cfg, st, terr, tgt, dist)
    w = head.tail.warm_next
    st = st._replace(cycle_idx=head.tail.cycle_idx, warm_u=w[0],
                     warm_z=w[1], warm_s=w[2], warm_valid=w[3],
                     warm_flag=w[4])
    calls = _count_host_builds(monkeypatch)
    head = loop._cycle_head(cfg, st, terr, tgt, dist)
    assert calls == []
    assert head.n_ticks == round(loop._gait_schedule(
        cfg, st, st.apf)[2] / cfg.sim.dt)
    assert bool(torch.isfinite(head.cyc.forces).all())


# ---------------------------------------------------------------------------
# the route: CPU tensors never reach the graph
# ---------------------------------------------------------------------------

def test_cpu_plan_and_cycle_run_eagerly(monkeypatch):
    """CPU tensors never reach graph.call: a plan, and a whole cycle (its
    head, its plan and its tail)."""
    def refuse(*a, **k):
        raise AssertionError("graph.call called on the CPU")
    monkeypatch.setattr(graph, "call", refuse)
    cfg = _cfg("resident")
    planner.plan(cfg, *_plan_inputs(cfg, 0))
    cfg = cfg.replace(sim=SimConfig(terrain_res=16, substeps=1),
                      gait=GaitConfig(trot_cycle=0.005))
    st, metrics = loop.run_cycle(cfg, *_head_args(cfg, "flat"))
    assert bool((st.cycle_idx == 1).all())
    assert bool(torch.isfinite(metrics.com).all())


def test_graph_call_takes_cuda_tensors_only():
    cfg = _cfg("resident")
    with pytest.raises(ValueError, match="CUDA graph"):
        graph.call(("plan", cfg), lambda a: planner._plan_eager(cfg, *a),
                   _plan_inputs(cfg, 0))


def test_plan_key_tells_warm_and_cone_rot_apart():
    """The layout a plan's graph is keyed on differs with warm=None and
    with cone_rot=None, which its code branches on."""
    cfg = _cfg("resident")
    x0, refs, warm = _plan_inputs(cfg, 0)
    sig = graph._signature
    rot = torch.eye(3, dtype=torch.float64).expand(B, H, 4, 3, 3)
    assert len({sig((x0, refs, warm)), sig((x0, refs, None)),
                sig((x0, refs._replace(cone_rot=rot), warm))}) == 3


def test_apf_constants_are_shared():
    """navigate's min-exit lateral vector and RoM box come from the
    per-device cache."""
    from apf_quadruped_tpu_torch.config import ApfConfig, RobotConfig
    cfg = ApfConfig(min_exit=True)
    state = apf.init_state((B,), torch.float64, CPU)
    feet = torch.zeros(B, 4, 2, dtype=torch.float64)
    com = torch.zeros(B, 2, dtype=torch.float64)
    tgt = torch.ones(B, 2, dtype=torch.float64)
    first = apf.navigate(cfg, state, feet, com, tgt, robot=RobotConfig())
    with pytest.MonkeyPatch.context() as mp:
        calls = _count_host_builds(mp)
        second = apf.navigate(cfg, state, feet, com, tgt,
                              robot=RobotConfig())
    assert calls == []
    assert torch.equal(first.step_targets, second.step_targets)
