"""Batched scenario sweeps.

Port of the single-device part of apf_quadruped_tpu/runtime/sweep.py:
a batch of (terrain, target, disturbance) scenarios walks through the
closed loop (runtime/loop.py) in lockstep.  The JAX module vmaps a
single-scenario loop; the port's loop is batched already, so the batch
runs as it is.  Scenario generation is host-side data loading: the native
C++ rasterizer (runtime/native.py) when g++ builds it, else numpy with the
JAX module's RNG order; the two give different scenarios from one seed.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .._device import resolve_device
from ..config import EngineConfig
from ..sim import disturbance, terrain as terrain_mod
from . import loop, native


class Scenario(NamedTuple):
    """A batch of scenarios: terrain mu-map + navigation target +
    disturbances + spawn pose, scenario axis first."""

    mu_map: torch.Tensor       # (B, res, res)
    target_xy: torch.Tensor    # (B, 2)
    dist_sched: torch.Tensor   # (B, n_events, 8) — sim.disturbance rows
    spawn_xy: torch.Tensor     # (B, 2)
    spawn_yaw: torch.Tensor    # (B,)


class SweepResult(NamedTuple):
    final_com: torch.Tensor     # (B, 3)
    goal_dist: torch.Tensor     # (B,) final xy distance to target
    upright: torch.Tensor       # (B,) final R[2,2]
    fell: torch.Tensor          # (B,) bool
    rob_mean: torch.Tensor      # (B,) last-cycle robustness
    qp_converged: torch.Tensor  # (B,) mean WBC convergence
    slip_frac: torch.Tensor     # (B,) mean slipping fraction
    metrics: loop.CycleMetrics  # stacked (B, n_cycles, ...)


def cli_config(iters: int = 15) -> EngineConfig:
    """The configuration of the JAX CLI's `sweep` subcommand
    (apf_quadruped_tpu/__main__.py `_cfg` for DogBot): trot, H=20, one SQP
    iteration, SolverConfig(iters, reltol=abstol=1e-2),
    slack_weight_trot=1e6."""
    from ..config import GaitConfig, MpcConfig, SolverConfig, WbcConfig
    return EngineConfig(gait=GaitConfig(mode="trot"),
                        mpc=MpcConfig(horizon=20, sqp_iters=1),
                        solver=SolverConfig(iters=iters, reltol=1e-2,
                                            abstol=1e-2),
                        wbc=WbcConfig(slack_weight_trot=1e6))


def random_scenarios(cfg: EngineConfig, n: int, seed: int = 0,
                     n_patches: int = 4, dtype=torch.float32,
                     use_native: bool | None = None,
                     device="cuda") -> Scenario:
    """Randomized slippery-patch navigation scenarios, on the card unless
    `device` says otherwise."""
    device = resolve_device(device)
    def t(v):
        return torch.as_tensor(np.asarray(v), device=device).to(dtype)

    zeros = dict(spawn_xy=torch.zeros((n, 2), dtype=dtype, device=device),
                 spawn_yaw=torch.zeros(n, dtype=dtype, device=device))
    if use_native is None:
        use_native = native.available()
    if use_native:
        gen = native
        mu = gen.terrains(n, cfg.sim.terrain_res, cfg.sim.terrain_extent,
                          cfg.sim.mu_default, n_patches, seed=seed + 1)
        return Scenario(mu_map=t(mu),
                        target_xy=t(gen.targets(n, seed=seed + 2)),
                        dist_sched=t(gen.disturbances(n, 2, horizon_s=4.0,
                                                      seed=seed + 3)),
                        **zeros)
    rng = np.random.default_rng(seed)
    terr = terrain_mod.random_patches(cfg.sim, rng, n_patches=n_patches,
                                      batch=n, dtype=dtype, device=device)
    targets = np.stack([rng.uniform(-0.6, 0.6, n), rng.uniform(1.2, 2.2, n)],
                       axis=-1)
    dist = disturbance.random_pushes(rng, horizon_s=4.0, n=2, f_max=40.0,
                                     batch=n, dtype=dtype, device=device)
    return Scenario(mu_map=terr.mu_map, target_xy=t(targets),
                    dist_sched=dist, **zeros)


def _terrain(cfg: EngineConfig, scn: Scenario) -> terrain_mod.Terrain:
    return terrain_mod.Terrain(mu_map=scn.mu_map,
                               extent=cfg.sim.terrain_extent,
                               res=cfg.sim.terrain_res)


def init_batch(cfg: EngineConfig, scn: Scenario) -> loop.LoopState:
    """Initial LoopStates for a scenario batch (spawn xy applied to the
    base; the friction anchors stay at the origin spawn, as in the JAX
    module)."""
    st = loop.init(cfg, scn.target_xy.shape[0], dtype=scn.target_xy.dtype,
                   device=scn.target_xy.device)
    p = torch.cat([scn.spawn_xy, st.sim.p_base[:, 2:3]], dim=-1)
    return st._replace(sim=st.sim._replace(p_base=p))


def step_batch(cfg: EngineConfig, scn: Scenario, states: loop.LoopState,
               n_cycles: int):
    """Advance a batch of LoopStates n_cycles: (states', CycleMetrics
    stacked (B, n_cycles, ...))."""
    return loop.run(cfg, states, _terrain(cfg, scn), scn.target_xy,
                    scn.dist_sched, n_cycles)


def run_batch(cfg: EngineConfig, scn: Scenario, n_cycles: int) -> SweepResult:
    """Walk every scenario of the batch n_cycles replan cycles."""
    states, metrics = step_batch(cfg, scn, init_batch(cfg, scn), n_cycles)
    return result(scn, states, metrics)


def result(scn: Scenario, st2: loop.LoopState,
           metrics: loop.CycleMetrics) -> SweepResult:
    """The sweep statistics of final states and stacked metrics."""
    com = metrics.com[:, -1]
    upright = st2.sim.R_wb[:, 2, 2]
    return SweepResult(
        final_com=com,
        goal_dist=torch.linalg.vector_norm(com[:, 0:2] - scn.target_xy,
                                           dim=-1),
        upright=upright, fell=upright < 0.7,
        rob_mean=metrics.rob_mean[:, -1],
        qp_converged=metrics.qp_converged.mean(dim=-1),
        slip_frac=metrics.slip_ticks.mean(dim=-1), metrics=metrics)


def run_resumable(*args, **kwargs):
    raise NotImplementedError(
        "run_resumable (chunked sweeps with checkpoint/resume) is not ported "
        "yet (ROADMAP queue 1, item 15)")


def step_batch_sharded(*args, **kwargs):
    raise NotImplementedError(
        "step_batch_sharded (the batch sharded over devices) is not ported "
        "yet (ROADMAP queue 1, item 17)")


def run_sharded(*args, **kwargs):
    raise NotImplementedError(
        "run_sharded (the batch sharded over devices) is not ported yet "
        "(ROADMAP queue 1, item 17)")
