"""Articulated floating-base physics with penalty contact (the Gazebo
replacement).

Port of apf_quadruped_tpu/sim/physics.py, batched over scenarios (leading
dims on every SimState field).  Semi-implicit Euler on the full 18-DoF
model (models/rbd.py):

    u+ = u + dt M^-1 (S' tau + J_c' f_c + J_d' f_dist - h),  pose+ from u+

with the mass-matrix solve through ops/chol.py (the CUDA kernels on the
card).  Contact per foot: a normal spring-damper along the terrain normal
and an anchor-based stick-slip tangential spring clamped to the friction
cone mu(x, y) f_n; a clamped foot drags its anchor (Coulomb sliding) and
counts as slipping.  A blown-up lane is kept finite (nan_to_num + clip) so
it can be flagged instead of poisoning the batch.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..config import EngineConfig
from ..models import rbd
from ..ops.chol import spd_factor, spd_solve
from ..ops.rotations import rot_z, skew
from . import terrain as terrain_mod


class SimState(NamedTuple):
    p_base: torch.Tensor   # (.., 3)
    R_wb: torch.Tensor     # (.., 3, 3)
    q: torch.Tensor        # (.., 12)
    u: torch.Tensor        # (.., 18) mixed velocity [v_base, omega, qd]
    t: torch.Tensor        # (..,) sim time
    anchor: torch.Tensor   # (.., 4, 2) tangential friction anchors (world xy)


class ContactInfo(NamedTuple):
    forces: torch.Tensor       # (.., 4, 3) world contact force per foot
    in_contact: torch.Tensor   # (.., 4) bool
    slipping: torch.Tensor     # (.., 4) bool — Coulomb clamp engaged, loaded
    # (.., 4, 3) contact force averaged over the step's substeps (filled by
    # step(); the momentum observer's measurement)
    forces_avg: torch.Tensor | None = None


def _contact(cfg: EngineConfig, st: SimState, terr: terrain_mod.Terrain,
             feet: torch.Tensor, Jc: torch.Tensor):
    s = cfg.sim
    v_feet = (Jc @ st.u.unsqueeze(-1)).reshape(feet.shape)
    p_xy = feet[..., 0:2]
    ground_z = terrain_mod.sample_height(terr, p_xy)
    normal = terrain_mod.sample_normal(terr, p_xy)

    depth = (cfg.robot.foot_radius - (feet[..., 2] - ground_z)) * normal[..., 2]
    in_c = depth > 0.0
    v_n = (normal * v_feet).sum(dim=-1)
    fn = torch.clamp(s.ground_kp * depth - s.ground_kd * v_n, min=0.0)
    fn = torch.where(in_c, fn, torch.zeros_like(fn))

    mu = terrain_mod.sample_mu(terr, p_xy)
    d3 = torch.cat([p_xy - st.anchor, torch.zeros_like(fn)[..., None]],
                   dim=-1)
    d_t = d3 - (normal * d3).sum(dim=-1, keepdim=True) * normal
    v_t = v_feet - v_n[..., None] * normal
    ft_raw = -s.tangent_kp * d_t - s.tangent_kd * v_t
    ft_norm = torch.linalg.vector_norm(ft_raw, dim=-1)
    ft_max = mu * fn
    over = ft_norm > ft_max
    scale = torch.where(over, ft_max / torch.clamp(ft_norm, min=1e-9),
                        torch.ones_like(ft_norm))
    ft = ft_raw * (scale * in_c)[..., None]
    slipping = in_c & over & (fn > 5.0)

    # free feet re-anchor at the foot; sliding feet drag the anchor so the
    # spring force equals the clamped force
    anchor_slide = p_xy + ft[..., 0:2] / s.tangent_kp
    new_anchor = torch.where(
        in_c[..., None], torch.where(over[..., None], anchor_slide, st.anchor),
        p_xy)
    f = ft + fn[..., None] * normal
    return ContactInfo(forces=f, in_contact=in_c, slipping=slipping), new_anchor


def contact_forces(cfg: EngineConfig, st: SimState,
                   terr: terrain_mod.Terrain):
    """Penalty contact at the four feet: (ContactInfo, new_anchor)."""
    feet = rbd.foot_positions_world(cfg.robot, st.p_base, st.R_wb, st.q)
    Jc = rbd.contact_jacobian_mixed(cfg.robot, st.p_base, st.R_wb, st.q)
    return _contact(cfg, st, terr, feet, Jc)


def step(cfg: EngineConfig, st: SimState, tau: torch.Tensor,
         terr: terrain_mod.Terrain, f_dist: torch.Tensor | None = None,
         f_feet: torch.Tensor | None = None) -> tuple[SimState, ContactInfo]:
    """One control-rate step = cfg.sim.substeps semi-implicit substeps.

    tau (.., 12) joint torques held over the step; f_dist (.., 3) optional
    external force at the base; f_feet (.., 4, 3) optional external forces
    at the feet, applied through the contact Jacobian.
    """
    dt = cfg.sim.dt / cfg.sim.substeps
    zeros3 = torch.zeros_like(tau[..., 0:3])
    ext = torch.cat([zeros3 if f_dist is None else f_dist, zeros3, tau],
                    dim=-1)
    forces = []
    for _ in range(cfg.sim.substeps):
        feet = rbd.foot_positions_world(cfg.robot, st.p_base, st.R_wb, st.q)
        Jc = rbd.contact_jacobian_mixed(cfg.robot, st.p_base, st.R_wb, st.q)
        info, anchor = _contact(cfg, st, terr, feet, Jc)
        M, h = rbd.mass_and_bias(cfg.robot, st.p_base, st.R_wb, st.q, st.u)
        f_ext = info.forces if f_feet is None else info.forces + f_feet
        gen = -h + (f_ext.flatten(-2).unsqueeze(-2) @ Jc).squeeze(-2)
        du = spd_solve(spd_factor(M), gen + ext)
        u = torch.clamp(torch.nan_to_num(st.u + dt * du), -1e3, 1e3)
        R = st.R_wb + dt * skew(u[..., 3:6]) @ st.R_wb
        # re-orthonormalize (Gram-Schmidt on columns)
        c0 = R[..., :, 0] / torch.linalg.vector_norm(R[..., :, 0], dim=-1,
                                                     keepdim=True)
        c1 = R[..., :, 1] - (c0 * R[..., :, 1]).sum(dim=-1,
                                                     keepdim=True) * c0
        c1 = c1 / torch.linalg.vector_norm(c1, dim=-1, keepdim=True)
        R = torch.stack([c0, c1, torch.linalg.cross(c0, c1)], dim=-1)
        st = SimState(p_base=st.p_base + dt * u[..., 0:3], R_wb=R,
                      q=st.q + dt * u[..., 6:18], u=u, t=st.t + dt,
                      anchor=anchor)
        forces.append(info.forces)
    return st, info._replace(forces_avg=torch.stack(forces).mean(dim=0))


def initial_state(cfg: EngineConfig, xy=(0.0, 0.0), yaw: float = 0.0,
                  dtype=torch.float32, batch=(), device=None) -> SimState:
    """Crouched standing spawn, feet just touching the ground, for a batch
    of `batch` identical scenarios."""
    from ..models.dogbot import nominal_stance
    from ..models.kinematics import stance_ik

    feet_b = nominal_stance(cfg.robot)
    q = stance_ik(cfg.robot, feet_b).to(dtype=dtype, device=device)
    z0 = -feet_b[0, 2] + cfg.robot.foot_radius
    p = torch.tensor([xy[0], xy[1], z0], dtype=dtype, device=device)
    R = rot_z(torch.tensor(yaw, dtype=dtype, device=device))

    def tile(v):
        return v.expand(batch + v.shape).clone()

    st = SimState(p_base=tile(p), R_wb=tile(R), q=tile(q),
                  u=torch.zeros(batch + (18,), dtype=dtype, device=device),
                  t=torch.zeros(batch, dtype=dtype, device=device),
                  anchor=torch.zeros(batch + (4, 2), dtype=dtype,
                                     device=device))
    feet = rbd.foot_positions_world(cfg.robot, st.p_base, st.R_wb, st.q)
    return st._replace(anchor=feet[..., 0:2].clone())
