"""Batched scenario sweeps: one batch on a device, or split over a mesh
of devices and processes, and resumable from checkpoints.

Port of apf_quadruped_tpu/runtime/sweep.py: a batch of (terrain, target,
disturbance) scenarios walks through the closed loop (runtime/loop.py) in
lockstep.  The JAX module vmaps a single-scenario loop; the port's loop
is batched already, so the batch runs as it is.  The sharded drivers
split the batch over parallel/mesh.py's device list and gather the result
on every process.  Scenario generation is host-side data loading: the
native C++ rasterizer (runtime/native.py) when g++ builds it, else numpy
with the JAX module's RNG order; the two give different scenarios from
one seed.
"""

from __future__ import annotations

import os
from typing import NamedTuple

import numpy as np
import torch

from .._device import resolve_device
from ..config import EngineConfig
from ..parallel import mesh as mesh_mod
from ..sim import disturbance, terrain as terrain_mod
from . import checkpoint, loop, native, profiling


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


def cli_config(iters: int = 15, robot: str = "dogbot", gait: str = "trot",
               sqp: int = 1) -> EngineConfig:
    """The configuration of the command line (apf_quadruped_tpu/__main__.py
    `_cfg`): the robot's closed-loop config (models/zoo.py for anymal and
    hyq), with the gait mode, horizon 40 for the 1 s crawl / adaptive
    cycle and 20 otherwise, `sqp` SQP iterations, SolverConfig(iters,
    reltol=abstol=1e-2) and slack_weight_trot=1e6 layered on top.  The
    defaults are the `sweep` command's DogBot trot."""
    from ..config import GaitConfig, MpcConfig, SolverConfig, WbcConfig
    from ..models import zoo
    base = (zoo.engine_config_for(robot) if robot != "dogbot"
            else EngineConfig())
    horizon = 40 if gait in ("crawl", "adaptive") else 20
    return base.replace(gait=GaitConfig(mode=gait),
                        mpc=MpcConfig(horizon=horizon, sqp_iters=sqp),
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
    stacked (B, n_cycles, ...)); a span `apf: sweep.step_batch` while a
    profiler records."""
    with profiling.trace("sweep.step_batch"):
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


def step_batch_sharded(cfg: EngineConfig, scn: list, states: list,
                       n_cycles: int, mesh: mesh_mod.ScenarioMesh):
    """step_batch on each shard of the mesh: `scn` and `states` are
    sharded trees (mesh.shard_batch), and each shard advances its lanes on
    its own device with no traffic between shards.  Returns the sharded
    (states', CycleMetrics)."""
    outs = [step_batch(cfg, s, st, n_cycles) for s, st in zip(scn, states)]
    return [o[0] for o in outs], [o[1] for o in outs]


def _concat_metrics(parts) -> loop.CycleMetrics:
    """Per-chunk CycleMetrics (B, n, ...) joined on the cycle axis."""
    return loop.CycleMetrics(*(torch.cat(v, dim=1) for v in zip(*parts)))


CURSOR = "cursor.pt"


def _shard_path(ckpt_dir: str, start: int) -> str:
    """The metric shard of the chunk that starts at cycle `start`."""
    return os.path.join(ckpt_dir, f"metrics-{start:08d}.pt")


def _restore_metrics(ckpt_dir: str, done: int, device) -> list:
    """The metric shards of the first `done` cycles, in order."""
    parts, start = [], 0
    while start < done:
        raw = checkpoint.restore(_shard_path(ckpt_dir, start), device=device)
        parts.append(loop.CycleMetrics(**raw["metrics"]))
        start += parts[-1].com.shape[1]
    if start != done:
        raise RuntimeError(f"{ckpt_dir}: the metric shards hold {start} "
                           f"cycles, the cursor {done}")
    return parts


def run_resumable(cfg: EngineConfig, scn: Scenario, n_cycles: int,
                  chunk: int = 2, ckpt_dir: str | None = None,
                  devices=None, _crash_after: int | None = None):
    """Chunked batch driver with checkpoint / resume: a preempted sweep
    resumes mid-run and finishes with results equal, bit for bit, to an
    uninterrupted one (the LoopState is the whole carried state).

    Drives init_batch / step_batch in `chunk`-cycle pieces.  After every
    chunk it writes into `ckpt_dir` that chunk's CycleMetrics as a shard of
    their own (`metrics-<first cycle>.pt`), then the cursor (`cursor.pt`:
    the cycles done and the LoopStates), each atomically: the bytes written
    a chunk do not grow with the cycles done, and a kill at any point
    leaves a cursor and the shards it counts.  No directory = no
    persistence, a plain chunked run.  On entry, an existing cursor
    resumes from its cycle.

    Returns (final LoopStates, CycleMetrics stacked (B, n_cycles, ...)).

    devices: None = the batch on its own device; a device list = the batch
    (and the carried states) split over the scenario mesh per chunk
    (step_batch_sharded).  Checkpoints gather to the host, written by
    process 0; a resume splits them again.  The result is gathered, the
    whole batch on every process.

    _crash_after: test hook, raise after that many chunks (a preemption
    after the save, like a kill between chunks).
    """
    mesh = None if devices is None else mesh_mod.scenario_mesh(devices)
    dev = scn.target_xy.device if mesh is None else mesh.devices[0]
    states = init_batch(cfg, scn)
    cursor = None if ckpt_dir is None else os.path.join(ckpt_dir, CURSOR)
    done, parts = 0, []
    if cursor is not None and checkpoint.exists(cursor):
        raw = checkpoint.restore(cursor, like={"cycles_done": 0,
                                               "states": states})
        done, states = int(raw["cycles_done"]), raw["states"]
        parts = _restore_metrics(ckpt_dir, done, dev)
    if mesh is not None:
        scn_run = mesh_mod.shard_batch(mesh, scn)
        states = mesh_mod.shard_batch(mesh, states)
    chunks_run = 0
    while done < n_cycles:
        n = min(chunk, n_cycles - done)
        if mesh is None:
            states, m = step_batch(cfg, scn, states, n)
        else:
            states, m = step_batch_sharded(cfg, scn_run, states, n, mesh)
            m = mesh_mod.gather(mesh, m)
        parts.append(m)
        if ckpt_dir is not None:
            whole = states if mesh is None else mesh_mod.gather(mesh, states)
            if mesh is None or mesh.rank == 0:
                checkpoint.save(_shard_path(ckpt_dir, done), {"metrics": m})
                checkpoint.save(cursor, {"cycles_done": done + n,
                                         "states": whole})
            if mesh is not None and mesh.world > 1:
                torch.distributed.barrier()
        done += n
        chunks_run += 1
        if _crash_after is not None and chunks_run >= _crash_after \
                and done < n_cycles:
            raise RuntimeError(f"simulated preemption after {done} cycles")
    if not parts:
        raise ValueError(
            f"run_resumable: nothing to run or return (n_cycles="
            f"{n_cycles} with no prior checkpoint progress)")
    if mesh is not None:
        states = mesh_mod.gather(mesh, states)
    return states, _concat_metrics(parts)


def run_sharded(cfg: EngineConfig, scn: Scenario, n_cycles: int,
                devices=None) -> tuple[SweepResult, dict]:
    """run_batch on each shard of the scenario mesh (parallel/mesh.py):
    the whole batch's SweepResult, gathered on every process, and the
    mean sweep stats (goal_dist, fell, qp_converged, slip_frac) averaged
    over the shards and the processes."""
    m = mesh_mod.scenario_mesh(devices)

    def per_shard(s):
        res = run_batch(cfg, s, n_cycles)
        stats = {"goal_dist": res.goal_dist.mean(),
                 "fell": res.fell.to(torch.float32).mean(),
                 "qp_converged": res.qp_converged.mean(),
                 "slip_frac": res.slip_frac.mean()}
        return res, stats

    return mesh_mod.sharded_map(m, per_shard)(mesh_mod.shard_batch(m, scn))
