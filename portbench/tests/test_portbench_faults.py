"""A run driven on the CPU, the look for a card skipped, with the timed
path broken underneath: `correct` comes out false for each fault a cell
can have, and true with none.  The faults: a step that returns its state
unchanged; half of the batch left out (its answers those of the other
half, or of the state it started from); an answer altered where it is
produced (by 0.1 N or N m, a few hundred float32 roundings of the
answers these cells compare); a solver that stops before its tolerances
(each answer from fewer interior-point iterations, as a broken
convergence test would give).  In a sweep the first two are planted
twice: in the cycle as a whole, and inside its tick scan, where the
cycle's plan is sound and only the ticks' state is wrong.  No cell spans
chips, so
none can leave out an exchange between them; the realtime cell's batch is
one robot, so it has no half to leave out."""

from __future__ import annotations

import dataclasses

import pytest
import torch

from portbench import harness

from . import small

SWEEPS = [w for w in small.WORKLOADS if w.endswith("sweep_b1024")]
PLANS = [w for w in small.WORKLOADS
         if small.cell(w).traffic["kind"] == "plan"]


def _correct(name: str, seed: int = 4242) -> bool:
    run = small.run(name, seed=seed)
    result, checks = harness.execute(run)
    return result["correct"]


def _half(t: torch.Tensor, fill: torch.Tensor) -> torch.Tensor:
    """t with its second half of lanes taken from `fill`."""
    h = t.shape[0] // 2
    return torch.cat([t[:h], fill[h:]])


def _half_tree(tree, fill):
    """Every tensor leaf of `tree` with its second half of lanes taken
    from the same leaf of `fill`."""
    if isinstance(tree, torch.Tensor):
        return _half(tree, fill)
    vals = [_half_tree(a, b) for a, b in zip(tree, fill)]
    return type(tree)(*vals) if hasattr(tree, "_fields") else tuple(vals)


def _early(cfg):
    """cfg with its solvers' tolerances so loose that each solve stops
    after its first iteration."""
    return cfg.replace(solver=dataclasses.replace(cfg.solver, reltol=1e9,
                                                  abstol=1e9))


# -- sweeps --------------------------------------------------------------

def _sweep_fault(monkeypatch, fault):
    from apf_quadruped_tpu_torch.runtime import sweep
    real = sweep.step_batch

    if fault in ("tick_unchanged", "tick_half"):
        from apf_quadruped_tpu_torch.runtime import loop
        real_step = loop._step

        def broken_step(cfg, cyc, carry, k, trace):
            new = real_step(cfg, cyc, carry, k, trace)
            return carry if fault == "tick_unchanged" else _half_tree(new,
                                                                      carry)
        monkeypatch.setattr(loop, "_step", broken_step)
        return

    def broken(cfg, scn, states, n):
        if fault == "stops_early":
            return real(_early(cfg), scn, states, n)
        new, m = real(cfg, scn, states, n)
        if fault == "unchanged":
            return states, m
        if fault == "half":
            return type(new)(*(
                type(a)(*(_half(x, y) for x, y in zip(a, b)))
                if isinstance(a, tuple) else _half(a, b)
                for a, b in zip(new, states))), m
        u = new.warm_u.clone()     # the plan's forces, as stashed
        u[0, 0, 2] += 0.1
        return new._replace(warm_u=u), m
    monkeypatch.setattr(sweep, "step_batch", broken)


@pytest.mark.parametrize("name", SWEEPS)
def test_sweep_sound(name):
    assert _correct(name)


@pytest.mark.parametrize("fault", ["unchanged", "half", "altered",
                                   "tick_unchanged", "tick_half",
                                   "stops_early"])
@pytest.mark.parametrize("name", SWEEPS)
def test_sweep_fault(monkeypatch, name, fault):
    _sweep_fault(monkeypatch, fault)
    assert not _correct(name)


# -- plans ---------------------------------------------------------------

def _plan_fault(monkeypatch, fault):
    from apf_quadruped_tpu_torch import planner
    real = planner.plan

    def broken(cfg, state0, refs, warm=None):
        if fault == "stops_early":
            return real(_early(cfg), state0, refs, warm)
        out = real(cfg, state0, refs, warm)
        if fault == "unchanged":      # no step from the initial point
            return out._replace(forces=torch.zeros_like(out.forces),
                                states=state0[:, None].expand_as(
                                    out.states).clone())
        if fault == "half":
            h = out.forces.shape[0] // 2
            return out._replace(forces=torch.cat([out.forces[:h]] * 2),
                                states=torch.cat([out.states[:h]] * 2))
        f = out.forces.clone()
        f[0, 0, 0, 2] += 0.1
        return out._replace(forces=f)
    monkeypatch.setattr(planner, "plan", broken)


@pytest.mark.parametrize("name", PLANS)
def test_plan_sound(name):
    assert _correct(name)


@pytest.mark.parametrize("fault", ["unchanged", "half", "altered",
                                   "stops_early"])
@pytest.mark.parametrize("name", PLANS)
def test_plan_fault(monkeypatch, name, fault):
    _plan_fault(monkeypatch, fault)
    assert not _correct(name)


# -- one robot -------------------------------------------------------------

def test_realtime_sound():
    assert _correct("dogbot_trot.realtime_b1")


# a warm replan stops after 2-7 iterations, too few for its counts to
# tell a stop after the first from one at the margin: the plan's early
# stop is the plan and sweep cells' to catch
@pytest.mark.parametrize("where, fault", [
    ("wbc", "unchanged"), ("wbc", "altered"), ("wbc", "stops_early"),
    ("plan", "unchanged"), ("plan", "altered")])
def test_realtime_fault(monkeypatch, where, fault):
    if where == "plan":
        _plan_fault(monkeypatch, fault)
    else:
        from apf_quadruped_tpu_torch import wbc
        real = wbc.solve
        calls = []

        def broken(cfg, st, ref):
            if fault == "stops_early":
                return real(_early(cfg), st, ref)
            out = real(cfg, st, ref)
            calls.append(1)
            if fault == "unchanged":
                return out._replace(tau=torch.zeros_like(out.tau),
                                    udot=torch.zeros_like(out.udot),
                                    forces=torch.zeros_like(out.forces))
            if len(calls) == 4:      # the first call of the window
                tau = out.tau.clone()
                tau[0, 0] += 0.1
                return out._replace(tau=tau)
            return out
        monkeypatch.setattr(wbc, "solve", broken)
    assert not _correct("dogbot_trot.realtime_b1")
