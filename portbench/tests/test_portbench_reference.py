"""The plain reference against the program's eager CPU path at a tiny
size, in float64: the same code, so the same bits; its `stop_at`
reproduces a lane stopped at its tolerances; and the sweep kind builds
the reference's ground and spawn from every leaf the host scenario
holds."""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

from portbench import common, gen, harness, spec

from . import small

CONF = spec.cell("dogbot_trot.sweep_b1024").config
F64 = torch.float64


def _configs(**gait):
    prog, ref = spec.program_config(CONF), spec.reference_config(CONF)
    if gait:
        prog = prog.replace(gait=dataclasses.replace(prog.gait, **gait))
        ref = ref.replace(gait=dataclasses.replace(ref.gait, **gait))
    return prog, ref


def _leaves(tree) -> list:
    out = []
    common.tmap(out.append, tree)
    return out


def _same(a, b):
    """Every tensor leaf of two trees equal, NaN included."""
    la, lb = _leaves(a), _leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype and x.shape == y.shape
        assert torch.equal(x, y) or torch.allclose(x, y, rtol=0, atol=0,
                                                   equal_nan=True)


def test_cycle_equals_the_programs():
    from apf_quadruped_tpu_torch.runtime import sweep as psweep
    from portbench.reference.runtime import loop as rloop
    from portbench.reference.sim import terrain as rterrain
    prog, ref = _configs(trot_cycle=0.05)
    scn = psweep.random_scenarios(prog, 2, seed=5, dtype=F64,
                                  use_native=False, device="cpu")
    st = psweep.init_batch(prog, scn)
    st, _ = psweep.step_batch(prog, scn, st, 1)      # a warm second cycle
    p_st, p_m = psweep.step_batch(prog, scn, st, 1)
    terr = rterrain.Terrain(mu_map=scn.mu_map, extent=ref.sim.terrain_extent,
                            res=ref.sim.terrain_res)
    r_st, r_m = rloop.run_cycle(ref, common.recast(st,
                                                   common.reference_types()),
                                terr, scn.target_xy, scn.dist_sched)
    _same(p_st, r_st)
    _same(common.tmap(lambda t: t[:, 0], p_m), r_m)


def test_plan_and_wbc_equal_the_programs():
    from apf_quadruped_tpu_torch import planner as pplanner, wbc as pwbc
    from portbench.reference import planner as rplanner, wbc as rwbc
    prog, ref = _configs()
    h = gen.plan_problems(ref, 3, gen.rng(1, 2))
    t = {k: torch.as_tensor(v, dtype=F64) for k, v in h.items()}
    pp = pplanner.plan(prog, t["x0"], pplanner.MpcRefs(
        t["contacts"], t["feet_w"], t["x_ref"], t["yaw_ref"]))
    rp = rplanner.plan(ref, t["x0"], rplanner.MpcRefs(
        t["contacts"], t["feet_w"], t["x_ref"], t["yaw_ref"]))
    _same(pp, rp)
    w = gen.wbc_states(ref, 3, gen.rng(1, 3))
    tw = {k: torch.as_tensor(v, dtype=None if k == "crawl" else F64)
          for k, v in w.items()}
    keys_st = ("p_base", "R_wb", "q", "u", "contact", "crawl", "cone_rot")
    pw = pwbc.solve(prog, pwbc.WbcState(*(tw[k] for k in keys_st)),
                    pwbc.WbcRefs(*(tw[k] for k in pwbc.WbcRefs._fields)))
    rw = rwbc.solve(ref, rwbc.WbcState(*(tw[k] for k in keys_st)),
                    rwbc.WbcRefs(*(tw[k] for k in rwbc.WbcRefs._fields)))
    _same(pw, rw)


def test_stop_at_reproduces_the_tolerance_stop():
    """Stopping each lane at the iteration it converged at gives the bits
    of the tolerance stop; stopping one earlier gives another answer."""
    from portbench.reference import planner as rplanner, wbc as rwbc
    _, ref = _configs()
    h = gen.plan_problems(ref, 4, gen.rng(2, 2))
    t = {k: torch.as_tensor(v, dtype=F64) for k, v in h.items()}
    refs = rplanner.MpcRefs(t["contacts"], t["feet_w"], t["x_ref"],
                            t["yaw_ref"])
    own = rplanner.plan(ref, t["x0"], refs)
    stop = own.sol.iters.to(torch.int64)
    again = rplanner.plan(ref, t["x0"], refs, stop_at=stop)
    assert torch.equal(own.forces, again.forces)
    early = rplanner.plan(ref, t["x0"], refs, stop_at=stop - 1)
    assert not torch.equal(own.forces, early.forces)
    w = gen.wbc_states(ref, 4, gen.rng(2, 3))
    tw = {k: torch.as_tensor(v, dtype=None if k == "crawl" else F64)
          for k, v in w.items()}
    st = rwbc.WbcState(*(tw[k] for k in ("p_base", "R_wb", "q", "u",
                                         "contact", "crawl", "cone_rot")))
    rf = rwbc.WbcRefs(*(tw[k] for k in rwbc.WbcRefs._fields))
    own = rwbc.solve(ref, st, rf)
    again = rwbc._solve_eager(ref, st, rf, own.sol.iters.to(torch.int64))
    assert torch.equal(own.tau, again.tau)
    assert np.all(own.sol.iters.numpy() > 0)


def test_tf32_control_switch_restores():
    from portbench.reference._precision import highest_precision, \
        tf32_control
    before = torch.backends.cuda.matmul.allow_tf32
    with highest_precision():
        assert not torch.backends.cuda.matmul.allow_tf32
    with tf32_control(), highest_precision():
        assert torch.backends.cuda.matmul.allow_tf32
    assert torch.backends.cuda.matmul.allow_tf32 == before


# -- the sweep kind's reference terrain and spawn ------------------------------

@pytest.fixture
def sweep_runner():
    rnr = harness.runner(small.run("dogbot_trot.sweep_b1024"))
    rnr.traffic()
    return rnr


def test_sweep_reference_ground_and_spawn_are_the_flat_ones(sweep_runner):
    """With no h_map in the host scenario, the reference's Terrain and
    spawn state are those the sweep kind built before it had one method
    for each: the friction map alone, and the spawn's xy on the base."""
    from portbench.reference.runtime import loop as rloop
    from portbench.reference.sim import terrain as rterrain
    rnr, rcfg = sweep_runner, sweep_runner.rcfg
    h = rnr.host[1]
    lanes = np.array([0, 2])
    for sel in (None, lanes):
        mu = torch.as_tensor(h["mu_map"] if sel is None else h["mu_map"][sel],
                             dtype=F64)
        want = rterrain.Terrain(mu_map=mu, extent=rcfg.sim.terrain_extent,
                                res=rcfg.sim.terrain_res)
        got = rnr.reference_terrain(1, F64, lanes=sel)
        assert got.h_map is None and (got.extent, got.res) == (
            want.extent, want.res)
        assert torch.equal(got.mu_map, want.mu_map)
    st = rloop.init(rcfg, rnr.tr["batch"], dtype=F64, device="cpu")
    want = st._replace(sim=st.sim._replace(p_base=torch.cat(
        [torch.as_tensor(h["spawn_xy"], dtype=F64), st.sim.p_base[:, 2:3]],
        dim=-1)))
    _same(rnr.reference_spawn(1, F64), want)


class _Handed(Exception):
    """Stops the reference where it is handed its terrain."""


def test_sweep_reference_walks_the_height_map_it_is_given(sweep_runner,
                                                          monkeypatch):
    """An h_map put into a host scenario reaches the reference's Terrain,
    every lane or the sampled ones, and both the head that judges the plan
    and the cycle that judges the state walk it."""
    from portbench.reference.runtime import loop as rloop
    rnr = sweep_runner
    res = rnr.rcfg.sim.terrain_res
    h_map = np.random.default_rng(0).uniform(
        0.0, 0.1, (rnr.tr["batch"], res, res)).astype(np.float32)
    rnr.host[0]["h_map"] = h_map
    got = rnr.reference_terrain(0, F64)
    assert torch.equal(got.h_map, torch.as_tensor(h_map, dtype=F64))
    got = rnr.reference_terrain(0, F64, lanes=np.array([3, 1]))
    assert torch.equal(got.h_map, torch.as_tensor(h_map[[3, 1]], dtype=F64))

    handed = []

    def take(cfg, st, terr, *rest, **kw):
        handed.append(terr.h_map)
        raise _Handed
    monkeypatch.setattr(rloop, "_cycle_head_eager", take)
    monkeypatch.setattr(rloop, "run_cycle", take)
    with pytest.raises(_Handed):
        rnr.reference_head(0, None, F64)
    st = rnr.sweep.init_batch(rnr.cfg, rnr.batches[0])
    rnr.start = common.floats_to(common.take(st, rnr.lanes), torch.float32)
    with pytest.raises(_Handed):
        rnr.reference_cycle(0, F64)
    assert torch.equal(handed[0], torch.as_tensor(h_map, dtype=F64))
    assert torch.equal(handed[1], torch.as_tensor(h_map[rnr.lanes],
                                                  dtype=F64))
