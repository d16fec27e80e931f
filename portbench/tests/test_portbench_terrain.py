"""The terrain kind (portbench/kinds/terrain.py) on the CPU at test size
(conftest.py): it keeps the contract of a cell; its generator is the
seed's alone and hands both sides the same maps; its reference spawn is
the program's `sweep.init_batch`; the five faults of a terrain sweep read
`correct` false (the four of test_portbench_faults.py, which runs every
sweep cell through them, and the program walking flat ground where the
scenario holds a height map); its two readers read nothing elsewhere; a
program whose sweeps cannot carry a height map ends the run at once."""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import pytest
import torch

from portbench import harness, marked, spec
from portbench.kinds import sweep as sweep_kind
from portbench.kinds import terrain as terrain_kind

from . import small
from .test_portbench_faults import _correct, _sweep_fault
from .test_portbench_files import _keeps_the_contract, _mark, _trace

NAME = "dogbot_towr_terrain.terrain_sweep_b1024"
F64 = torch.float64
READERS = ("ground_feet_share.sweep", "tick_ground_device_ms.sweep")


def _runner(seed=12345):
    rnr = harness.runner(small.run(NAME, seed=seed))
    rnr.traffic()
    return rnr


def test_the_kind_keeps_the_contract():
    cell = spec.cell(NAME)
    _keeps_the_contract(cell)
    assert issubclass(terrain_kind.Runner, sweep_kind.Runner)
    assert cell.traffic["kind"] == "terrain"
    assert set(cell.traffic["worlds"]) == {"slope", "stairs"}
    assert 0 <= cell.traffic["check_cycle"] < round(
        cell.traffic["sweep_sim_seconds"]
        / cell.config["engine"]["gait"]["trot_cycle"])
    names = {m["name"] for m in cell.per_layer}
    assert set(READERS) <= names
    assert {m["name"] for m in cell.end_to_end} == {"scenario_ticks_per_s",
                                                     "setup_s"}


def test_the_generator_is_the_seeds_and_both_sides_get_its_maps():
    from portbench.reference.sim import terrain as rterrain
    a, b, other = _runner(7), _runner(7), _runner(8)
    tr = a.tr
    worlds = {w: rterrain.HEIGHT_WORLDS[w](a.rcfg.sim, dtype=F64,
                                           device="cpu").h_map.numpy()
              for w in tr["worlds"]}
    for j, (ha, hb) in enumerate(zip(a.host, b.host)):
        assert ha.keys() == hb.keys() and "h_map" in ha
        for k in ha:
            np.testing.assert_array_equal(ha[k], hb[k], err_msg=k)
            assert ha[k].dtype in (np.float32, np.bool_), k
        deal = a.deals[j]
        counts = [deal.count(i) for i in range(len(tr["worlds"]))]
        assert max(counts) - min(counts) <= 1
        for lane, w in enumerate(deal):
            np.testing.assert_array_equal(
                ha["h_map"][lane], worlds[tr["worlds"][w]].astype(np.float32))
        xy = ha["spawn_xy"]
        assert np.all((xy[:, 0] >= tr["spawn_x"][0])
                      & (xy[:, 0] <= tr["spawn_x"][1])
                      & (xy[:, 1] >= tr["spawn_y"][0])
                      & (xy[:, 1] <= tr["spawn_y"][1]))
        # the program gets the host's float32 arrays as they are
        scn = a.batches[j]
        for k, v in ha.items():
            assert torch.equal(getattr(scn, k), torch.as_tensor(v)), k
        # and the reference walks the same ground
        got = a.reference_terrain(j, torch.float32)
        assert torch.equal(got.h_map, scn.h_map)
        assert torch.equal(got.mu_map, scn.mu_map)
    assert not all(np.array_equal(h["spawn_xy"], g["spawn_xy"])
                   for h, g in zip(a.host, other.host))


def test_the_reference_spawn_is_the_programs_init_batch():
    rnr = _runner()
    host = rnr.host[1]
    host["spawn_yaw"] = np.linspace(-0.4, 0.4, rnr.tr["batch"]).astype(
        np.float32)
    scn = rnr.sweep.Scenario(**{k: torch.as_tensor(v, dtype=None if
                                                    v.dtype == np.bool_
                                                    else F64)
                                for k, v in host.items()})
    prog = rnr.sweep.init_batch(rnr.cfg, scn)
    ref = rnr.reference_spawn(1, F64)
    ref_leaves, prog_leaves = [], []
    from apf_quadruped_tpu_torch.parallel.mesh import tree_map
    tree_map(ref_leaves.append, ref)
    tree_map(prog_leaves.append, prog)
    assert len(ref_leaves) == len(prog_leaves)
    for r, p in zip(ref_leaves, prog_leaves):
        assert r.dtype == p.dtype and r.shape == p.shape
        torch.testing.assert_close(r, p, rtol=0, atol=1e-12)
    assert not torch.equal(prog.sim.R_wb[0], prog.sim.R_wb[-1])


@pytest.mark.parametrize("fault", ["ground_ignored", "unchanged", "half",
                                   "altered", "stops_early"])
def test_fault(monkeypatch, fault):
    """Each fault reads `correct` false; "ground_ignored" hands the program
    the scenario without its height map, so it walks flat ground."""
    if fault == "ground_ignored":
        from apf_quadruped_tpu_torch.runtime import sweep
        real = sweep.step_batch
        monkeypatch.setattr(sweep, "step_batch", lambda cfg, scn, st, n: real(
            cfg, scn._replace(h_map=None), st, n))
    else:
        _sweep_fault(monkeypatch, fault)
    assert not _correct(NAME)


def test_the_checked_cycle_is_check_cycle(monkeypatch):
    """The comparison reads the first sweep's cycle `check_cycle`, and the
    window does not close before it has run."""
    rnr = harness.runner(small.run(NAME, seconds=0.0))
    rnr.traffic()
    rnr.warm()
    rnr.window()
    j, start, after, m = rnr.checked
    assert j == 0 and rnr.check_cycle == 1
    assert int(start.cycle_idx[0]) == rnr.check_cycle
    assert int(after.cycle_idx[0]) == rnr.check_cycle + 1
    assert 0.0 <= rnr.out["ground_feet_share"] <= 1.0
    assert len(rnr.out["ground_feet_by_cycle"]) == rnr.check_cycle + 1
    rnr.release()
    found = rnr.check()
    limits = {k for k in rnr.run.cell.limits if k != "floor"}
    assert limits == {"plan_ratio_p99", "plan_iters_short", "state_gap",
                      "cold_plan_ratio", "cold_plan_iters_short"}
    assert found["plan_ratio_p99"] <= found["plan_ratio"]
    assert limits <= set(found)
    # the cold plan is the first cycle's from the reference's own spawn
    assert found["cold_plan_ratio"] < rnr.run.cell.limits["cold_plan_ratio"]
    # the control's second float32 answer: on the CPU the reference's own
    # float32 head again, so each lane lies its float32 distance away
    seen = rnr.witness()
    assert seen["witness"].shape == seen["upright"].shape == (
        rnr.tr["batch"],)
    assert seen["witness_plan_ratio_p99"] <= seen["witness_plan_ratio"] <= 1.0


@pytest.mark.parametrize("metric", READERS)
def test_the_readers_read_nothing_elsewhere(metric):
    read = spec.reader(metric)
    flat = {"kind": "sweep", "trace": None, "qp_converged_share": 1.0}
    for obs in ({}, flat, {"kind": "plan"}, {"kind": "realtime"}):
        assert read(obs) is None


def test_the_ground_share_reads_the_window():
    read = spec.reader("ground_feet_share.sweep")
    assert read({"kind": "sweep", "worlds": ["slope"],
                 "ground_feet_share": 0.25}) == 25.0


def _tick(t0, ground):
    """One marked tick's marks and kernels, each stage busy 1 us; with
    `ground`, the cone bases and one substep's lookups in `ground`."""
    stages = (["tick.refs", "ground", "wbc.build", "wbc.qp", "physics",
               "ground", "physics", "tick.tail"] if ground else
              ["tick.refs", "wbc.build", "wbc.qp", "physics", "tick.tail"])
    out, t = [], t0
    for s in stages:
        out += [_mark(s, t), (s, t + 2.0, t + 3.0)]
        t += 4.0
    return out + [_mark("tick.end", t)]


def test_marked_numbers_add_the_ground_stages():
    from apf_quadruped_tpu_torch.runtime import profiling
    key = [("tick.refs", "tick.end")]
    seen = marked.read_units(_trace(_tick(0.0, True) + _tick(100.0, True)),
                             key, profiling.STAGES)
    got = terrain_kind.Runner.marked_numbers(seen)
    assert got["tick_ground_ms"] == pytest.approx(2e-3)
    assert got["tick_physics_ms"] == pytest.approx(2e-3)
    assert got["tick_qp_ms"] == pytest.approx(1e-3)
    flat = marked.read_units(_trace(_tick(0.0, False)), key,
                             profiling.STAGES)
    assert "tick_ground_ms" not in terrain_kind.Runner.marked_numbers(flat)


def test_a_program_without_height_maps_ends_the_run(monkeypatch):
    """On a program whose sweep.Scenario has no h_map the run stops before
    its set-up with an exit code of its own, and prints no result."""
    from apf_quadruped_tpu_torch.runtime import sweep

    class Flat(NamedTuple):
        mu_map: torch.Tensor
        target_xy: torch.Tensor
        dist_sched: torch.Tensor
        spawn_xy: torch.Tensor
        spawn_yaw: torch.Tensor

    monkeypatch.setattr(sweep, "Scenario", Flat)
    with pytest.raises(SystemExit) as e:
        harness.runner(small.run(NAME))
    assert e.value.code == terrain_kind.NO_HEIGHT_MAPS
