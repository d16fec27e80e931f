"""Analytic 3-DoF leg kinematics for DogBot (roll-pitch-knee chains).

Port of apf_quadruped_tpu/models/kinematics.py: closed-form forward
kinematics of the xacro chain and closed-form Jacobians (revolute joint
axis x lever arm) where the JAX module takes jacfwd; jdot_qd keeps the
JAX module's nested forward-mode derivative (torch.func.jvp), so the code
is functional (no in-place writes).  The four legs are evaluated together,
as one leg axis, where the JAX module vmaps over them; every function
takes any leading batch dims.  models/rbd.py builds its link chains on
leg_chains.

Chain per leg (sigma_x = right/left, sigma_y = front/back):
    body --(p_hip)--> roll about (0, sigma_y, 0)
         --(p_shift lateral)--> pitch about (sigma_x, 0, 0)
         --(0,0,-L_upper)--> knee about (-sigma_x, 0, 0)
         --> foot point at (0, -0.035, -L_lower) in lower-leg frame.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
from torch.func import jvp

from ..config import RobotConfig
from ..ops.rotations import rot_x, rot_y, skew
from .dogbot import LEG_SIGNS, hip_positions


@functools.lru_cache(maxsize=None)
def _consts(cfg: RobotConfig, dtype, device):
    """Per-device constants, built once: leg signs (4, 2), hips (4, 3),
    the upper/lower link vectors."""
    def t(v):
        return torch.as_tensor(np.asarray(v, np.float64), dtype=dtype,
                               device=device)
    return dict(signs=t(LEG_SIGNS), hips=t(hip_positions(cfg)),
                p2=t([0.0, 0.0, -cfg.upper_leg_len]),
                p3=t([0.0, cfg.foot_y_offset, -cfg.lower_leg_len]),
                eye3=t(np.eye(3)),
                # leg_block[l, 0, m, 0] = 1 where l == m: block-diagonal
                leg_block=t(np.eye(4)[:, None, :, None]))


def _leg_chain(cfg: RobotConfig, signs: torch.Tensor, hip: torch.Tensor,
               q: torch.Tensor):
    """Foot (.., 3), joint origins (.., 3, 3), joint axes (.., 3, 3) and
    link rotations (.., 3, 3, 3) of a leg chain in the base frame (roll,
    pitch, knee in that order; the links hip, upper, lower)."""
    c = _consts(cfg, q.dtype, q.device)
    sx, sy = signs[..., 0], signs[..., 1]
    r1 = rot_y(sy * q[..., 0])          # roll about the body's long axis
    r12 = r1 @ rot_x(sx * q[..., 1])    # pitch
    r123 = r12 @ rot_x(-sx * q[..., 2])  # knee (opposite sense)
    zero = torch.zeros_like(sx)
    ex = torch.stack([sx, zero, zero], dim=-1)
    shift = (cfg.leg_offset_side - cfg.hip_offset_side) * sx[..., None]
    o1 = hip + r1[..., :, 0] * shift
    o2 = o1 + r12 @ c["p2"]
    foot = o2 + r123 @ c["p3"]
    roll = torch.stack([zero, sy, zero], dim=-1).expand(foot.shape)
    axes = torch.stack([roll, (r1 @ ex[..., None])[..., 0],
                        -(r12 @ ex[..., None])[..., 0]], dim=-2)
    origins = torch.stack([hip.expand(foot.shape), o1, o2], dim=-2)
    return foot, origins, axes, torch.stack([r1, r12, r123], dim=-3)


def leg_fk(cfg: RobotConfig, signs: torch.Tensor, hip: torch.Tensor,
           q: torch.Tensor) -> torch.Tensor:
    """Foot position in base frame. signs (.., 2), hip (.., 3),
    q (.., 3) = (roll, pitch, knee)."""
    return _leg_chain(cfg, signs, hip, q)[0]


def leg_chains(cfg: RobotConfig, q: torch.Tensor):
    """_leg_chain of all four legs, q (.., 12) leg-major: feet (.., 4, 3),
    joint origins and axes (.., 4, 3, 3), link rotations (.., 4, 3, 3, 3)."""
    c = _consts(cfg, q.dtype, q.device)
    return _leg_chain(cfg, c["signs"], c["hips"],
                      q.reshape(q.shape[:-1] + (4, 3)))


def fk(cfg: RobotConfig, q: torch.Tensor) -> torch.Tensor:
    """All-leg forward kinematics: q (.., 12) leg-major -> (.., 4, 3)
    feet in base frame."""
    return leg_chains(cfg, q)[0]


def hip_positions_static(cfg: RobotConfig) -> np.ndarray:
    return hip_positions(cfg)


def _geometric(foot, origins, axes):
    """Revolute-joint Jacobian: column j = axis_j x (foot - origin_j);
    (.., 3 xyz, 3 joints)."""
    return torch.linalg.cross(axes, foot[..., None, :] - origins).transpose(
        -1, -2)


def leg_jacobian(cfg: RobotConfig, leg: int,
                 q_leg: torch.Tensor) -> torch.Tensor:
    """(.., 3, 3) Jacobian d(foot pos)/d(q_leg) in base frame for a static
    leg index."""
    c = _consts(cfg, q_leg.dtype, q_leg.device)
    foot, origins, axes, _ = _leg_chain(cfg, c["signs"][leg], c["hips"][leg],
                                        q_leg)
    return _geometric(foot, origins, axes)


def jacobians(cfg: RobotConfig, q: torch.Tensor) -> torch.Tensor:
    """(.., 4, 3, 3) per-leg foot Jacobians in base frame, q (.., 12), in
    closed form (joint axis x lever arm; the JAX module takes jacfwd of
    the same FK)."""
    foot, origins, axes, _ = leg_chains(cfg, q)
    return _geometric(foot, origins, axes)


def jdot_qd(cfg: RobotConfig, q: torch.Tensor,
            qd: torch.Tensor) -> torch.Tensor:
    """(.., 4, 3) per-leg Jdot @ qd bias (base frame): the second
    directional derivative of the foot positions along qd."""
    def vel(z):
        return jvp(lambda zz: fk(cfg, zz), (z,), (qd,))[1]

    return jvp(vel, (q,), (qd,))[1]


def stack_leg_rows(cfg: RobotConfig, r: torch.Tensor,
                   jw: torch.Tensor) -> torch.Tensor:
    """(.., 12, 18) rows [I, -skew(r_i), 0 .. jw_i .. 0] per leg i, from
    lever arms r (.., 4, 3) and world leg Jacobians jw (.., 4, 3, 3)."""
    c = _consts(cfg, jw.dtype, jw.device)
    batch = jw.shape[:-3]
    lin = c["eye3"].expand(batch + (4, 3, 3))
    blk = (jw[..., None, :] * c["leg_block"]).reshape(batch + (4, 3, 12))
    J = torch.cat([lin, -skew(r), blk], dim=-1)
    return J.reshape(batch + (12, 18))


def contact_jacobian(cfg: RobotConfig, q: torch.Tensor, R_wb: torch.Tensor,
                     com_w: torch.Tensor,
                     base_pos_w: torch.Tensor) -> torch.Tensor:
    """(.., 12, 18) stacked linear contact Jacobian in CoM coordinates:
    v_foot_i = v_com + omega x r_i + R_wb J_leg_i qd_i, r_i = p_foot_i -
    p_com (world)."""
    feet_b = fk(cfg, q)
    jl = jacobians(cfg, q)
    feet_w = base_pos_w[..., None, :] + feet_b @ R_wb.transpose(-1, -2)
    r = feet_w - com_w[..., None, :]
    jw = R_wb[..., None, :, :] @ jl
    return stack_leg_rows(cfg, r, jw)


def stance_ik(cfg: RobotConfig, targets_b, iters: int = 30) -> torch.Tensor:
    """(12,) float64 joint angles whose FK hits `targets_b` ((4, 3) base
    frame feet): damped Newton on the analytic FK from a knee-bent seed,
    per leg (the analogue of the reference's spawn joint configuration).
    Runs on the CPU in float64; callers cast."""
    f64 = torch.float64
    seed = np.array([0.0, 0.4, 0.8]) * np.array(
        [[1.0, sx, sx] for sx, _ in np.asarray(LEG_SIGNS)])
    q = torch.as_tensor(seed.reshape(-1), dtype=f64)
    tgt = torch.as_tensor(np.asarray(targets_b), dtype=f64)
    damp = 1e-6 * torch.eye(3, dtype=f64)
    for _ in range(iters):
        err = tgt - fk(cfg, q)                            # (4, 3)
        jl = jacobians(cfg, q)                            # (4, 3, 3)
        H = jl.transpose(-1, -2) @ jl + damp
        dq = torch.linalg.solve(H, (jl.transpose(-1, -2)
                                    @ err[..., None]))[..., 0]
        q = q + dq.reshape(-1)
    return q
