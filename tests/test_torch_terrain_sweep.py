"""Sweeps with a height map a lane (runtime/sweep.py), on the CPU.

A Scenario may carry `h_map` (B, res, res): each lane walks its own
ground through the sweep entry points (step_batch, run_resumable,
step_batch_sharded), from `init_batch`, which puts each lane at rest at
its spawn as loop.init(xy, yaw) puts one robot.  random_scenarios deals
towr's height worlds over the lanes and draws spawns after every draw it
made before, so without them its scenarios are the same.  On a height
map the tick counts its loaded feet on raised or tilted ground
(CycleMetrics.ground_feet) and marks its ground lookups as a stage
`ground`; on flat ground neither adds an operation.

The closed loop on the worlds is held to the JAX package through
tests/data/world_golden.npz (its `run --world` runs from loop.init's `xy`,
slope and stairs, 2 cycles, with test_torch_loop_modes.py's gates), lane
by lane of one B=4 sweep, and to portbench/reference's loop to 1e-9.
"""

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from apf_quadruped_tpu_torch.config import (EngineConfig, GaitConfig,
                                            MpcConfig, SimConfig,
                                            SolverConfig, WbcConfig)
from apf_quadruped_tpu_torch.parallel import mesh as mesh_mod
from apf_quadruped_tpu_torch.parallel.mesh import tree_map
from apf_quadruped_tpu_torch.runtime import (graph, loop, native, profiling,
                                             sweep)
from apf_quadruped_tpu_torch.sim import disturbance, physics, terrain

torch.set_num_threads(1)

F64 = torch.float64
# tests/test_sweep.py's small plumbing config, with two substeps a tick
CFG = EngineConfig(
    gait=GaitConfig(trot_cycle=0.1),
    mpc=MpcConfig(horizon=4, dt=0.025),
    sim=SimConfig(substeps=2, terrain_res=16),
    solver=SolverConfig(iters=5),
    wbc=WbcConfig(slack_weight_trot=1e6),
)
WORLDS = ["slope", "stairs"]
# spawns at the features' edge: the front feet on the feature at once
EDGE = dict(worlds=WORLDS, spawn_x=(-0.3, 0.3), spawn_y=(0.85, 0.95))
# the dispatched operations of the flat tick of _tick_inputs(False) (CFG,
# B=2, float64, random_scenarios seed 17), counted before the ground
# counter and marks existed: a change to the flat tick changes this
# number, knowingly
FLAT_TICK_OPS = 7616


def scenarios(n, seed, cfg=CFG, **kw):
    return sweep.random_scenarios(cfg, n, seed=seed, dtype=F64,
                                  use_native=False, device="cpu", **kw)


def leaves(tree):
    out = []
    tree_map(out.append, tree)
    return out


def assert_equal_trees(a, b):
    la, lb = leaves(a), leaves(b)
    assert len(la) == len(lb) and la
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype and x.shape == y.shape
        assert torch.equal(x, y)


# -- the scenarios ---------------------------------------------------------

@pytest.mark.parametrize("use_native", [False, True])
def test_scenarios_without_worlds_are_unchanged(use_native):
    """The draws of worlds and spawns come after the others: the friction
    maps, targets and pushes are those of a batch without them, on the
    numpy path and on the native one (where g++ builds it)."""
    if use_native and not native.available():
        use_native = False      # the numpy path alone on this host
    kw = dict(dtype=F64, use_native=use_native, device="cpu")
    plain = sweep.random_scenarios(CFG, 6, seed=5, **kw)
    hilly = sweep.random_scenarios(CFG, 6, seed=5, **kw, **EDGE)
    assert plain.h_map is None
    assert not plain.spawn_xy.any() and not plain.spawn_yaw.any()
    for k in ("mu_map", "target_xy", "dist_sched"):
        assert torch.equal(getattr(plain, k), getattr(hilly, k)), k
    assert hilly.h_map.shape == plain.mu_map.shape
    assert not hilly.spawn_yaw.any()


def test_worlds_are_dealt_evenly_in_a_seeded_order():
    maps = {w: terrain.HEIGHT_WORLDS[w](CFG.sim, dtype=F64).h_map
            for w in WORLDS}
    deals = []
    for seed in range(4):
        scn = scenarios(7, seed, **EDGE)
        again = scenarios(7, seed, **EDGE)
        assert_equal_trees(scn, again)
        deal = [next(i for i, w in enumerate(WORLDS)
                     if torch.equal(h, maps[w])) for h in scn.h_map]
        assert sorted(deal) == [0, 0, 0, 0, 1, 1, 1]
        deals.append(deal)
        xy = scn.spawn_xy
        assert bool(((xy[:, 0] >= -0.3) & (xy[:, 0] <= 0.3)
                     & (xy[:, 1] >= 0.85) & (xy[:, 1] <= 0.95)).all())
    assert len({tuple(d) for d in deals}) > 1


# -- init_batch ------------------------------------------------------------

def test_init_batch_at_zero_spawns_is_unchanged():
    """At the origin every lane's LoopState is loop.init's with the
    spawn's xy on the base, as init_batch made it before it placed lanes
    at their spawns, bit for bit."""
    scn = scenarios(3, 1)
    st = loop.init(CFG, 3, dtype=F64, device="cpu")
    before = st._replace(sim=st.sim._replace(p_base=torch.cat(
        [scn.spawn_xy, st.sim.p_base[:, 2:3]], dim=-1)))
    assert_equal_trees(sweep.init_batch(CFG, scn), before)


def test_init_batch_puts_each_lane_at_its_spawn():
    """Each lane is loop.init(xy, yaw) of its spawn: the base's pose and
    the friction anchors under its feet there."""
    scn = scenarios(3, 2, **EDGE)
    scn = scn._replace(spawn_yaw=torch.tensor([0.0, 0.4, -1.1], dtype=F64))
    st = sweep.init_batch(CFG, scn)
    for i in range(3):
        one = loop.init(CFG, 1, xy=tuple(scn.spawn_xy[i].tolist()),
                        yaw=float(scn.spawn_yaw[i]), dtype=F64, device="cpu")
        for a, b in zip(leaves(one), leaves(st)):
            torch.testing.assert_close(a[0], b[i], rtol=0, atol=1e-15)
    assert not torch.allclose(st.sim.anchor[0], st.sim.anchor[1])


# -- the closed loop on the worlds, against JAX and the reference ------------

@pytest.fixture(scope="module")
def world_golden():
    from test_torch_loop_worlds import GOLDEN
    with np.load(GOLDEN) as f:
        return {k: f[k] for k in f.files}


# the lanes' worlds: each world twice, in a mixed order
LANES = ("slope", "stairs", "stairs", "slope")


def world_scenarios(golden, dtype=F64):
    """The golden's runs as one batch: each lane on its world, spawned
    where the golden spawned it, target (0, 1.5), no push, the worlds'
    friction (mu_default everywhere)."""
    cfg = sweep.cli_config()
    maps = {w: terrain.HEIGHT_WORLDS[w](cfg.sim, dtype=dtype) for w in WORLDS}
    B = len(LANES)
    return cfg, sweep.Scenario(
        mu_map=torch.stack([maps[w].mu_map for w in LANES]),
        target_xy=torch.tensor([[0.0, 1.5]] * B, dtype=dtype),
        dist_sched=disturbance.empty(dtype)[None].expand(B, 1, 8).clone(),
        spawn_xy=torch.tensor([golden[f"spawn.{w}"] for w in LANES],
                              dtype=dtype),
        spawn_yaw=torch.zeros(B, dtype=dtype),
        h_map=torch.stack([maps[w].h_map for w in LANES]))


@pytest.fixture(scope="module")
def world_sweep(world_golden):
    """[(LoopState, CycleMetrics)] after each of 2 cycles of the B=4
    sweep, one step_batch call a cycle."""
    cfg, scn = world_scenarios(world_golden)
    st = sweep.init_batch(cfg, scn)
    out = []
    for _ in range(2):
        st, m = sweep.step_batch(cfg, scn, st, 1)
        out.append((st, m))
    return cfg, scn, out


def _lane(tree, i):
    return type(tree)(*(_lane(v, i) if hasattr(v, "_fields") else
                        None if v is None else v[i:i + 1] for v in tree))


@pytest.mark.parametrize("lane", range(len(LANES)))
def test_sweep_on_worlds_matches_jax(world_golden, world_sweep, lane):
    from test_torch_loop_modes import check_case
    from test_torch_loop_worlds import BEYOND_F64P, TWIN_FLIPS
    world = LANES[lane]
    runs = {world: [(_lane(st, lane), _lane(m, lane))
                    for st, m in world_sweep[2]]}
    for k in range(2):
        check_case(world_golden, runs, world, k, TWIN_FLIPS, BEYOND_F64P)


def test_sweep_on_worlds_matches_the_reference(world_sweep):
    """The same batch through portbench/reference's loop (the port's eager
    code, frozen), from its own per-lane spawn: every LoopState leaf and
    every CycleMetrics field it has within 1e-9."""
    from portbench.reference.models import rbd as rrbd
    from portbench.reference.ops.rotations import rot_z as rrot_z
    from portbench.reference.runtime import loop as rloop
    from portbench.reference.sim import terrain as rterrain
    from portbench.spec import reference_config
    import dataclasses
    import json
    cfg, scn, port = world_sweep
    rcfg = reference_config({"engine": json.loads(json.dumps(
        dataclasses.asdict(cfg)))})
    B = scn.target_xy.shape[0]
    st = rloop.init(rcfg, B, dtype=F64, device="cpu")
    p = torch.cat([scn.spawn_xy, st.sim.p_base[:, 2:3]], dim=-1)
    R = rrot_z(scn.spawn_yaw)
    feet = rrbd.foot_positions_world(rcfg.robot, p, R, st.sim.q)
    st = st._replace(sim=st.sim._replace(p_base=p, R_wb=R,
                                         anchor=feet[..., 0:2].clone()))
    terr = rterrain.Terrain(mu_map=scn.mu_map, extent=rcfg.sim.terrain_extent,
                            res=rcfg.sim.terrain_res, h_map=scn.h_map)
    for k in range(2):
        st, m = rloop.run_cycle(rcfg, st, terr, scn.target_xy,
                                scn.dist_sched)
        pst, pm = port[k]
        for a, b in zip(leaves(st), leaves(pst)):
            torch.testing.assert_close(b, a, rtol=0, atol=1e-9)
        for name, v in m._asdict().items():
            torch.testing.assert_close(getattr(pm, name)[:, 0], v, rtol=0,
                                       atol=1e-9, msg=name)


# -- the sweep entry points carry the height map ---------------------------

@pytest.fixture(scope="module")
def edge():
    """(scenarios at the features' edge, B=4; four cycles of step_batch
    from init_batch in one call)."""
    scn = scenarios(4, 11, **EDGE)
    return scn, sweep.step_batch(CFG, scn, sweep.init_batch(CFG, scn), 4)


def test_the_height_map_moves_the_sweep(edge):
    scn, (st, m) = edge
    flat, _ = sweep.step_batch(CFG, scn._replace(h_map=None),
                               sweep.init_batch(CFG, scn), 4)
    assert not torch.equal(flat.sim.p_base, st.sim.p_base)
    assert bool(m.ground_feet.any())


def test_resumable_killed_and_resumed_carries_the_height_map(edge, tmp_path):
    scn, straight = edge
    ck = tmp_path / "ck"
    with pytest.raises(RuntimeError, match="simulated preemption"):
        sweep.run_resumable(CFG, scn, 4, chunk=1, ckpt_dir=ck,
                            _crash_after=2)
    assert_equal_trees(sweep.run_resumable(CFG, scn, 4, chunk=1,
                                           ckpt_dir=ck), straight)


def test_sharded_sweeps_carry_the_height_map(edge):
    """Each shard walks its own lanes' height maps: the split run equals
    step_batch on each half of the batch, bit for bit.  (Not the whole
    batch's run: the CPU planner rounds a lane's plan by ~1e-12 otherwise in
    a batch of another size, and two cycles on the features carry that
    far.)"""
    scn, _ = edge
    mesh = mesh_mod.scenario_mesh(["cpu", "cpu"])
    shards = mesh_mod.shard_batch(mesh, scn)
    assert all(s.h_map.shape[0] == 2 for s in shards)
    halves = [sweep.step_batch(CFG, s, sweep.init_batch(CFG, s), 4)
              for s in shards]
    want = mesh_mod.gather(mesh, halves)
    st, m = sweep.step_batch_sharded(
        CFG, shards, mesh_mod.shard_batch(mesh, sweep.init_batch(CFG, scn)),
        4, mesh)
    assert_equal_trees((mesh_mod.gather(mesh, st), mesh_mod.gather(mesh, m)),
                       want)
    assert_equal_trees(sweep.run_resumable(CFG, scn, 4, chunk=2,
                                           devices=["cpu", "cpu"]), want)
    flat = scn._replace(h_map=None)
    assert all(s.h_map is None for s in mesh_mod.shard_batch(mesh, flat))


# -- the ground counter and the ground marks --------------------------------

def test_ground_feet_is_a_recount_of_the_ticks_contact(monkeypatch):
    """ground_feet equals a plain recount: over the ticks, each tick's last
    substep's feet in contact with a normal force over 5 N, those of them
    on ground raised over 1 cm or tilted past 5 degrees, from the
    terrain's own height and normal at the feet; None on flat ground."""
    scn = scenarios(4, 13, **EDGE)
    seen = []
    real = physics._contact

    def spy(cfg, st, terr, feet, Jc, flag_ground=False):
        out = real(cfg, st, terr, feet, Jc, flag_ground)
        if flag_ground:
            seen.append((terr, feet, out[0]))
        return out
    monkeypatch.setattr(physics, "_contact", spy)
    _, m = sweep.step_batch(CFG, scn, sweep.init_batch(CFG, scn), 1)
    assert len(seen) == round(CFG.gait.trot_cycle / CFG.sim.dt)
    loaded = on = 0
    for terr, feet, info in seen:
        xy = feet[..., 0:2]
        normal = terrain.sample_normal(terr, xy)
        fn = (info.forces * normal).sum(dim=-1)
        here = info.in_contact & (fn > 5.0)
        raised = ((terrain.sample_height(terr, xy) > 0.01)
                  | (normal[..., 2] < np.cos(np.radians(5.0))))
        loaded = loaded + here.sum(dim=-1)
        on = on + (here & raised).sum(dim=-1)
    want = on.to(F64) / torch.clamp(loaded.to(F64), min=1.0)
    torch.testing.assert_close(m.ground_feet[:, 0], want, rtol=0, atol=1e-12)
    assert bool((want > 0).any())
    seen.clear()
    _, m = sweep.step_batch(CFG, scn._replace(h_map=None),
                            sweep.init_batch(CFG, scn), 1)
    assert all(info.on_feature is None for _, _, info in seen)
    assert m.ground_feet is None


def _tick_inputs(hilly: bool):
    """(the cycle's inputs, the first tick's carry) of a cycle at CFG, B=2,
    float64, at the features' edge on the worlds' height maps, or on flat
    ground."""
    seen = {}
    real = loop._scan_ticks

    def spy(cfg_, cyc, carry, n):
        seen.update(cyc=cyc, carry=carry)
        return real(cfg_, cyc, carry, n)
    scn = scenarios(2, 17, **EDGE) if hilly else scenarios(2, 17)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(loop, "_scan_ticks", spy)
        sweep.step_batch(CFG, scn, sweep.init_batch(CFG, scn), 1)
    return seen["cyc"], seen["carry"]


@pytest.mark.parametrize("hilly", [False, True])
def test_ground_marks_only_on_a_height_map(monkeypatch, hilly):
    cyc, carry = _tick_inputs(hilly)
    marks = []
    monkeypatch.setattr(profiling, "mark", lambda s, like: marks.append(s))
    loop._step(CFG, cyc, carry, torch.zeros(1, dtype=torch.int64),
               loop._trace_buffers(2, 1, F64, "cpu",
                                   loop._trace_names(cyc.terr)))
    wbc = ["wbc.build", "wbc.qp", "wbc.torque", "wbc.end"]
    if hilly:
        want = (["tick.refs", "ground"] + wbc + ["physics"]
                + ["ground", "physics"] * CFG.sim.substeps
                + ["tick.tail", "tick.end"])
    else:
        want = ["tick.refs"] + wbc + ["physics", "tick.tail", "tick.end"]
    assert marks == want


class _Ops(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.n += 1
        return func(*args, **(kwargs or {}))


def test_the_flat_tick_is_unchanged_and_graphed_apart():
    """The flat tick dispatches the operations it did before the ground
    counter and marks; a tick on a height map dispatches more, and its
    graph's key differs from the flat tick's, so that each captures a
    graph of its own."""
    flat, carry = _tick_inputs(False)
    hilly, carry_h = _tick_inputs(True)
    k = torch.zeros(1, dtype=torch.int64)
    with _Ops() as ops:
        loop._step(CFG, flat, carry, k,
                   loop._trace_buffers(2, 1, F64, "cpu"))
    assert ops.n == FLAT_TICK_OPS
    with _Ops() as ops_h:
        loop._step(CFG, hilly, carry_h, k, loop._trace_buffers(
            2, 1, F64, "cpu", loop._trace_names(hilly.terr)))
    assert ops_h.n > ops.n
    key = ("tick", CFG, 20)
    assert (graph._full_key("scan", key, "cpu", flat, carry)
            != graph._full_key("scan", key, "cpu", hilly, carry_h))
