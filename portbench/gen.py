"""The benchmark's traffic generators, frozen copies of the program's.

  * `scenarios`: `apf_quadruped_tpu_torch.runtime.sweep.random_scenarios`'
    numpy path (slippery-patch friction maps, navigation targets, pushes),
    drawn from the rng in its order;
  * `plan_problems`: `apf_quadruped_tpu_torch.problems.bench_problem`, the
    planner problem of bench.py (DogBot standing in a trot schedule, a 6 cm
    CoM step, seeded noise), with the contact schedule open: its gait
    flags dealt evenly over the lanes (bench.py's flag 1 by default);
  * `wbc_states`: `apf_quadruped_tpu_torch.problems.wbc_problem`, the WBC
    latency benchmark's states (the standing spawn jittered, four feet
    down).

They compute with the reference's modules on the host in float64 and
return numpy arrays in float32: the inputs that the program and the
reference are both handed.  Every draw comes from `rng(seed, ...)`, so
one seed gives the same inputs.
"""

from __future__ import annotations

import numpy as np
import torch

from .reference import gait, planner
from .reference.models import rbd, srb
from .reference.models.dogbot import nominal_stance
from .reference.sim import disturbance, physics, terrain

F32 = np.float32


def rng(seed: int, *stream: int) -> np.random.Generator:
    """The generator of stream `stream` of run seed `seed` (any whole
    number: it is taken modulo 2**64)."""
    return np.random.default_rng(np.random.SeedSequence(
        [seed % (1 << 64), *stream]))


def scenarios(cfg, n: int, gen: np.random.Generator, n_patches: int,
              target_x, target_y, pushes: int, push_f_max: float,
              push_horizon_s: float) -> dict:
    """A batch of n slippery-patch scenarios: mu_map (n, res, res),
    target_xy (n, 2), dist_sched (n, pushes, 8), spawn_xy (n, 2) and
    spawn_yaw (n,), all zero spawns."""
    terr = terrain.random_patches(cfg.sim, gen, n_patches=n_patches, batch=n,
                                  dtype=torch.float64, device="cpu")
    targets = np.stack([gen.uniform(*target_x, n), gen.uniform(*target_y, n)],
                       axis=-1)
    dist = disturbance.random_pushes(gen, horizon_s=push_horizon_s, n=pushes,
                                     f_max=push_f_max, batch=n,
                                     dtype=torch.float64, device="cpu")
    return {"mu_map": terr.mu_map.numpy().astype(F32),
            "target_xy": targets.astype(F32),
            "dist_sched": dist.numpy().astype(F32),
            "spawn_xy": np.zeros((n, 2), F32),
            "spawn_yaw": np.zeros(n, F32)}


def plan_problems(cfg, B: int, gen: np.random.Generator,
                  gait_flags=(1,)) -> dict:
    """(state0 and MpcRefs fields) of bench.py's planner problem at batch
    B: x0 (B, 13), contacts (B, H, 4), feet_w (B, H, 4, 3), x_ref
    (B, H, 13), yaw_ref (B,).

    Each lane's contact schedule is one of `gait_flags` over a cycle of
    the horizon (H dt), every flag on an equal share of the lanes (as near
    as B allows) in an order drawn from `gen` after the state's draws;
    one flag draws nothing, so the default is bench.py's problem bit for
    bit."""
    f64 = dict(dtype=torch.float64)

    def t(v):
        return torch.as_tensor(np.asarray(v), **f64)

    com0 = t(np.array([0.0, 0.0, 0.4]) + gen.normal(size=(B, 3)) * 0.01)
    yaw = t(gen.normal(size=B) * 0.1)
    vel = t(gen.normal(size=(B, 3)) * 0.05)
    feet0 = t(nominal_stance(cfg.robot))[None] + com0[:, None, :]
    feet0[..., 2] = 0.0
    com_des = com0 + t([0.0, 0.06, 0.0])
    H, dt = cfg.mpc.horizon, cfg.mpc.dt
    cycle = torch.full((B,), H * dt, **f64)
    flags = np.resize(np.asarray(gait_flags, np.int32), B)
    if len(gait_flags) > 1:
        flags = gen.permutation(flags)
    contacts = gait.horizon_contacts(
        torch.as_tensor(flags), torch.zeros(B, **f64), dt, H, cycle,
        dtype=torch.float64)
    zeros3 = torch.zeros((B, 3), **f64)
    zero = torch.zeros_like(yaw)
    x0 = srb.pack_state(torch.stack([zero, zero, yaw], dim=-1), com0, zeros3,
                        vel)
    out = {"x0": x0, "contacts": contacts,
           "feet_w": planner.foothold_schedule(feet0, feet0, contacts),
           "x_ref": planner.reference_trajectory(cfg, zeros3, com0, com_des,
                                                 yaw, cycle),
           "yaw_ref": yaw}
    return {k: v.numpy().astype(F32) for k, v in out.items()}


def wbc_states(cfg, B: int, gen: np.random.Generator) -> dict:
    """The WbcState and WbcRefs fields of the WBC latency benchmark's
    states at batch B: the standing spawn with q jittered by N(0, 0.02)
    and u drawn from N(0, 0.01), all four feet in contact, no crawl,
    identity cone bases; the CoM reference at the CoM, every other
    reference zero."""
    st0 = physics.initial_state(cfg, dtype=torch.float64, device="cpu")
    q = st0.q.numpy()[None] + gen.normal(size=(B, 12)) * 0.02
    u = gen.normal(size=(B, 18)) * 0.01
    p_base = np.broadcast_to(st0.p_base.numpy(), (B, 3)).astype(F32)
    R_wb = np.broadcast_to(st0.R_wb.numpy(), (B, 3, 3)).astype(F32)
    q, u = q.astype(F32), u.astype(F32)
    com = rbd.com_position(cfg.robot, *(torch.as_tensor(v, dtype=torch.float64)
                                        for v in (p_base, R_wb, q)))
    z3, z43 = np.zeros((B, 3), F32), np.zeros((B, 4, 3), F32)
    return {"p_base": p_base, "R_wb": R_wb, "q": q, "u": u,
            "contact": np.ones((B, 4), F32), "crawl": np.zeros(B, bool),
            "cone_rot": np.broadcast_to(np.eye(3), (B, 4, 3, 3)).astype(F32),
            "com_pos": com.numpy().astype(F32), "com_vel": z3, "com_acc": z3,
            "rpy": z3, "omega": z3, "omega_dot": z3, "swing_pos": z43,
            "swing_vel": z43, "swing_acc": z43}
