"""Floating-base rigid-body dynamics of the full 18-DoF DogBot.

Port of apf_quadruped_tpu/models/rbd.py.  Mixed coordinates: generalized
velocity u = [v_base_world(3), omega_world(3), qd(12)], base position p,
orientation R (world_R_base); dynamics M(q) u' + h(q, u) = S' tau + J' f.
Link CoM velocities are LINEAR in u, so

    M = sum_b m_b Jv_b' Jv_b + Jw_b' I_b^w Jw_b
    h = sum_b m_b Jv_b'(a_b + g e_z) + Jw_b'(I_b^w dw_b + w_b x I_b^w w_b)

with (a_b, dw_b) the bias accelerations (u' = 0) along the state flow
q' = qd, R' = skew(omega) R.

The Jacobians are in closed form (revolute joint axis x lever arm), where
the JAX module takes vmapped jvps over the 18 basis tangents of the same
velocities: the same numbers up to rounding, and no Jacobian over the
batch, which would couple lanes.  The four legs are one axis; every
function takes any leading batch dims and is functional, since
observer.mdot_u differentiates mass_matrix once more.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..config import RobotConfig
from ..ops.rotations import skew
from . import kinematics
from .dogbot import LEG_SIGNS
from .kinematics import fk, jacobians, stack_leg_rows

NB = 13        # moving bodies: body + 4 x (hip, upper, lower+foot)
NV = 18        # generalized-velocity dim
GRAVITY = 9.81


def _link_constants_np(cfg: RobotConfig):
    """masses (NB,), com offsets in link frame (NB, 3), inertias (NB, 3, 3);
    body order [body, then per leg (BR, BL, FL, FR): hip, upper, lower],
    the foot lumped into the lower leg."""
    lower_m = cfg.lower_mass + cfg.foot_mass
    foot_pos = (0.0, cfg.foot_y_offset, -cfg.lower_leg_len)
    lower_com = tuple((cfg.lower_mass * c + cfg.foot_mass * f) / lower_m
                      for c, f in zip(cfg.lower_com, foot_pos))
    masses = [cfg.body_mass]
    coms = [(0.0, 0.0, 0.0)]
    inertias = [np.diag(cfg.body_inertia)]
    for sx, _sy in np.asarray(LEG_SIGNS):
        masses += [cfg.hip_mass, cfg.upper_mass, lower_m]
        coms += [(cfg.hip_com_x * sx, 0.0, 0.0),
                 (cfg.upper_com[0] * sx, cfg.upper_com[1], cfg.upper_com[2]),
                 lower_com]
        inertias += [np.diag(cfg.hip_inertia), np.diag(cfg.upper_inertia),
                     np.diag(cfg.lower_inertia)]
    return (np.asarray(masses, np.float64), np.asarray(coms, np.float64),
            np.stack(inertias).astype(np.float64))


@functools.lru_cache(maxsize=None)
def _consts(cfg: RobotConfig, dtype, device):
    """Per-device constants, built once (no host copies on the hot path)."""
    def t(v):
        return torch.as_tensor(np.asarray(v, np.float64), dtype=dtype,
                               device=device)
    masses, coms, inertias = _link_constants_np(cfg)
    return dict(
        masses=t(masses), coms=t(coms), inertias=t(inertias),
        leg_coms=t(coms[1:].reshape(4, 3, 3)),
        g=t([0.0, 0.0, GRAVITY]), eye3=t(np.eye(3)),
        # chain[k, j] = 1 where joint j moves link k (j <= k)
        chain=t(np.tril(np.ones((3, 3)))),
        # leg_block[l, 0, 0, m, 0] = 1 where l == m: block-diagonal columns
        leg_block=t(np.eye(4)[:, None, None, :, None]))


def _mv(M, v):
    return (M @ v.unsqueeze(-1)).squeeze(-1)


def _mtv(M, v):
    return (v.unsqueeze(-2) @ M).squeeze(-2)


def _rotate(R, x):
    """R (.., 3, 3) applied to the rows of x (.., K, 3)."""
    return x @ R.transpose(-1, -2)


def total_mass(cfg: RobotConfig) -> float:
    """Static Python float: sum of link masses (should equal cfg.mass)."""
    return float(cfg.body_mass + 4 * (cfg.hip_mass + cfg.upper_mass
                                      + cfg.lower_mass + cfg.foot_mass))


TOTAL_MASS = total_mass(RobotConfig())


def link_kinematics(cfg: RobotConfig, q):
    """Base-frame kinematics of all NB links, q (.., 12) leg-major.
    Returns (R_links (.., NB, 3, 3), p_coms (.., NB, 3))."""
    c = _consts(cfg, q.dtype, q.device)
    batch = q.shape[:-1]
    R_legs, p_legs, _, _, _ = _chain(cfg, q)
    R_links = torch.cat([c["eye3"].expand(batch + (1, 3, 3)),
                         R_legs.reshape(batch + (12, 3, 3))], dim=-3)
    p_coms = torch.cat([c["coms"][0].expand(batch + (1, 3)),
                        p_legs.reshape(batch + (12, 3))], dim=-2)
    return R_links, p_coms


def _chain(cfg: RobotConfig, q):
    """The leg chains in the base frame, legs as one axis: link rotations
    (.., 4, 3, 3, 3), link CoMs (.., 4, 3, 3), joint origins (.., 4, 3, 3),
    joint axes (.., 4, 3, 3), links and joints in chain order, and the feet
    (.., 4, 3)."""
    c = _consts(cfg, q.dtype, q.device)
    feet, origins, axes, R_legs = kinematics.leg_chains(cfg, q)
    return (R_legs, origins + _mv(R_legs, c["leg_coms"]), origins, axes,
            feet)


def _com_columns(cfg: RobotConfig, p_legs, origins, axes):
    """(.., 4, 3 links, 3 joints, 3): d(link CoM)/d(q_joint) in the base
    frame, axis_j x (p_k - o_j) for joints j <= k of the link's chain."""
    mask = _consts(cfg, p_legs.dtype, p_legs.device)["chain"]
    lever = p_legs[..., :, :, None, :] - origins[..., :, None, :, :]
    return (torch.linalg.cross(axes[..., :, None, :, :], lever)
            * mask[..., None])


def _jacobians(cfg: RobotConfig, R_wb, q):
    """(Jv, Jw), each (.., NB, 3, NV): the link CoM and angular velocities
    v = v_base + omega x r + R sum_j (z_j x (p - o_j)) qd_j and
    w = omega + R sum_j z_j qd_j are linear in u; these are their columns."""
    c = _consts(cfg, q.dtype, q.device)
    batch = q.shape[:-1]
    _, p_legs, origins, axes, _ = _chain(cfg, q)
    p_coms_b = torch.cat([c["coms"][0].expand(batch + (1, 3)),
                          p_legs.reshape(batch + (12, 3))], dim=-2)
    r = _rotate(R_wb, p_coms_b)
    cols_v = R_wb[..., None, None, :, :] @ _com_columns(
        cfg, p_legs, origins, axes).transpose(-1, -2)
    cols_w = (R_wb[..., None, :, :] @ axes.transpose(-1, -2))[
        ..., :, None, :, :] * c["chain"][:, None, :]

    def joint_block(cols):
        # (.., 4, 3 links, 3, 3 joints) -> (.., NB, 3, 12), block-diagonal
        # over legs, zero for the body
        blk = (cols[..., None, :] * c["leg_block"]).reshape(
            batch + (12, 3, 12))
        return torch.cat([torch.zeros_like(blk[..., :1, :, :]), blk], dim=-3)

    eye = c["eye3"].expand(batch + (NB, 3, 3))
    Jv = torch.cat([eye, -skew(r), joint_block(cols_v)], dim=-1)
    Jw = torch.cat([torch.zeros_like(eye), eye, joint_block(cols_w)], dim=-1)
    return Jv, Jw


def _inertia_world(cfg: RobotConfig, R_wb, q):
    """(.., NB, 3, 3) link rotational inertias in the world frame."""
    c = _consts(cfg, q.dtype, q.device)
    R_links_b, _ = link_kinematics(cfg, q)
    R_links_w = R_wb[..., None, :, :] @ R_links_b
    return R_links_w @ c["inertias"] @ R_links_w.transpose(-1, -2)


def _mass_from(cfg, Jv, Jw, I_w):
    masses = _consts(cfg, Jv.dtype, Jv.device)["masses"]
    # sum over links b and rows i: flatten (b, i) into one axis
    Jv_f, Jw_f = Jv.flatten(-3, -2), Jw.flatten(-3, -2)
    m3 = masses.repeat_interleave(3)[:, None]
    return (Jv_f.transpose(-1, -2) @ (m3 * Jv_f)
            + Jw_f.transpose(-1, -2) @ (I_w @ Jw).flatten(-3, -2))


def _flow(cfg: RobotConfig, R_wb, q, u):
    """The leg chains in the world frame (relative to the base origin)
    moving with velocity u, legs as one axis: joint origins O, axes Z,
    link CoMs P (.., 4, 3, 3), feet F (.., 4, 3); link angular velocities W
    and, with u' = 0, angular accelerations alpha (.., 4, 3, 3); CoM and
    joint-origin velocities vP, vO relative to the base origin's; CoM and
    foot accelerations aP (.., 4, 3, 3), aF (.., 4, 3).  The recursion of a
    revolute chain: w_k = w_parent + z_k qd_k, alpha_k = alpha_parent +
    (w_parent x z_k) qd_k, and for X on link k (origin O_k)
    v_X = v_O + w_k x (X - O_k), a_X = a_O + alpha_k x (X - O_k)
    + w_k x (w_k x (X - O_k))."""
    batch = q.shape[:-1]
    omega = u[..., 3:6]
    qq = u[..., 6:18].reshape(batch + (4, 3))[..., None]
    _, p_legs, origins, axes, feet = _chain(cfg, q)

    def world(x):
        return x @ R_wb[..., None, :, :].transpose(-1, -2)

    O, Z, P = world(origins), world(axes), world(p_legs)
    F = _rotate(R_wb, feet)
    om = omega[..., None, None, :].expand(batch + (4, 1, 3))
    W = om + torch.cumsum(Z * qq, dim=-2)               # link k = hip..lower
    W_par = torch.cat([om, W[..., :2, :]], dim=-2)      # joint j's parent
    alpha = torch.cumsum(torch.linalg.cross(W_par, Z) * qq, dim=-2)
    cross = torch.linalg.cross
    om1 = omega[..., None, :]
    v_o = cross(om1, O[..., 0, :])
    a_o = cross(om1, v_o)
    vO, vP, aP = [v_o], [], []
    for k in range(3):
        wk, ak = W[..., k, :], alpha[..., k, :]

        def move(X):
            d = X - O[..., k, :]
            wd = cross(wk, d)
            return v_o + wd, a_o + cross(ak, d) + cross(wk, wd)
        v, a = move(P[..., k, :])
        vP.append(v)
        aP.append(a)
        if k < 2:
            v_o, a_o = move(O[..., k + 1, :])
            vO.append(v_o)
    aF = move(F)[1]
    return dict(O=O, Z=Z, P=P, W=W, W_par=W_par, alpha=alpha,
                vO=torch.stack(vO, dim=-2), vP=torch.stack(vP, dim=-2),
                aP=torch.stack(aP, dim=-2), aF=aF)


def _accelerations(cfg: RobotConfig, R_wb, q, u, flow=None):
    """World-frame link angular velocities w (.., NB, 3) and, with u' = 0,
    the link CoM accelerations a (.., NB, 3), angular accelerations dw
    (.., NB, 3) and foot accelerations (.., 4, 3): the derivatives of the
    link and foot velocities along the state flow, which the JAX module
    takes with jax.jvp (here in closed form, _flow)."""
    c = _consts(cfg, q.dtype, q.device)
    batch = q.shape[:-1]
    f = _flow(cfg, R_wb, q, u) if flow is None else flow
    omega = u[..., 3:6]
    r0 = R_wb @ c["coms"][0]
    a_body = torch.linalg.cross(omega, torch.linalg.cross(omega, r0))
    a = torch.cat([a_body[..., None, :], f["aP"].reshape(batch + (12, 3))],
                  dim=-2)
    dw = torch.cat([torch.zeros_like(a_body[..., None, :]),
                    f["alpha"].reshape(batch + (12, 3))], dim=-2)
    w = torch.cat([omega[..., None, :], f["W"].reshape(batch + (12, 3))],
                  dim=-2)
    return w, a, dw, f["aF"]


def mdot_u(cfg: RobotConfig, R_wb, q, u):
    """(.., NV) Mdot u, the rate of the mass matrix along the state flow
    (R' = skew(omega) R, q' = qd) times u, in closed form: from
    M = sum_b m Jv'Jv + Jw' I Jw,
        Mdot u = sum_b m (Jvdot' v + Jv' a) + Jwdot' (I w)
                 + Jw' (w x I w + I alpha)
    with v, w the link velocities, a, alpha = Jdot u the bias
    accelerations and Jdot the rate of the geometric Jacobian: columns
    3:6 of Jv are -skew(r), so rate -skew(rdot); a joint column z_j x
    (p - o_j) has rate zdot_j x (p - o_j) + z_j x (v_p - v_oj), zdot_j =
    w_parent x z_j, and its Jw column z_j has rate zdot_j.  The JAX package
    takes one jvp of mass_matrix (runtime/observer.py)."""
    c = _consts(cfg, q.dtype, q.device)
    batch = q.shape[:-1]
    cross = torch.linalg.cross
    f = _flow(cfg, R_wb, q, u)
    w, a, dw, _ = _accelerations(cfg, R_wb, q, u, flow=f)
    Jv, Jw = _jacobians(cfg, R_wb, q)
    I_w = _inertia_world(cfg, R_wb, q)
    m = c["masses"]
    omega = u[..., 3:6]
    r0 = R_wb @ c["coms"][0]
    rdot = torch.cat([cross(omega, r0)[..., None, :],
                      f["vP"].reshape(batch + (12, 3))], dim=-2)
    v = u[..., None, 0:3] + rdot                       # link CoM velocities
    mv = m[:, None] * v
    Iw = _mv(I_w, w)
    out = (_mtv(Jv.flatten(-3, -2), (m[:, None] * a).flatten(-2))
           + _mtv(Jw.flatten(-3, -2), (cross(w, Iw) + _mv(I_w, dw))
                  .flatten(-2)))
    # Jdot' terms: columns 3:6, then each leg's joint columns
    base = cross(rdot, mv).sum(dim=-2)
    zdot = cross(f["W_par"], f["Z"])                   # (.., 4, 3 j, 3)
    lever = f["P"][..., :, None, :] - f["O"][..., None, :, :]
    rel_v = f["vP"][..., :, None, :] - f["vO"][..., None, :, :]
    col_rate = (cross(zdot[..., None, :, :], lever)
                + cross(f["Z"][..., None, :, :], rel_v))  # (.., 4, k, j, 3)
    mv_legs = mv[..., 1:, :].reshape(batch + (4, 3, 1, 3))
    Iw_legs = Iw[..., 1:, :].reshape(batch + (4, 3, 1, 3))
    joint = (((col_rate * mv_legs).sum(dim=-1)
              + (zdot[..., None, :, :] * Iw_legs).sum(dim=-1))
             * c["chain"]).sum(dim=-2)                 # (.., 4, 3 j)
    rate = torch.cat([torch.zeros_like(base), base,
                      joint.reshape(batch + (12,))], dim=-1)
    return out + rate


def _bias_from(cfg, R_wb, q, u, Jv, Jw, I_w):
    c = _consts(cfg, q.dtype, q.device)
    w, a_bias, dw_bias, _ = _accelerations(cfg, R_wb, q, u)
    f_lin = c["masses"][:, None] * (a_bias + c["g"])
    f_ang = _mv(I_w, dw_bias) + torch.linalg.cross(w, _mv(I_w, w))
    return (_mtv(Jv.flatten(-3, -2), f_lin.flatten(-2))
            + _mtv(Jw.flatten(-3, -2), f_ang.flatten(-2)))


def mass_matrix(cfg: RobotConfig, R_wb, q):
    """(.., NV, NV) free-floating mass matrix in mixed coordinates."""
    Jv, Jw = _jacobians(cfg, R_wb, q)
    return _mass_from(cfg, Jv, Jw, _inertia_world(cfg, R_wb, q))


def bias_forces(cfg: RobotConfig, p_base, R_wb, q, u):
    """(.., NV) Coriolis/centrifugal + gravity bias h(q, u); convention
    M u' + h = S' tau + J' f.  (p_base does not enter: the velocities do
    not depend on the base position.)"""
    del p_base
    Jv, Jw = _jacobians(cfg, R_wb, q)
    return _bias_from(cfg, R_wb, q, u, Jv, Jw, _inertia_world(cfg, R_wb, q))


def mass_and_bias(cfg: RobotConfig, p_base, R_wb, q, u):
    """(mass_matrix, bias_forces) sharing one Jacobian evaluation."""
    del p_base
    Jv, Jw = _jacobians(cfg, R_wb, q)
    I_w = _inertia_world(cfg, R_wb, q)
    return (_mass_from(cfg, Jv, Jw, I_w),
            _bias_from(cfg, R_wb, q, u, Jv, Jw, I_w))


def foot_positions_world(cfg: RobotConfig, p_base, R_wb, q):
    """(.., 4, 3) world foot-sphere centers."""
    return p_base[..., None, :] + _rotate(R_wb, fk(cfg, q))


def contact_jacobian_mixed(cfg: RobotConfig, p_base, R_wb, q):
    """(.., 12, NV) stacked linear foot Jacobian in mixed coordinates:
    v_foot_i = v_base + omega x (R p_fi_b) + R J_leg_i qd_i."""
    del p_base
    r = _rotate(R_wb, fk(cfg, q))
    jw = R_wb[..., None, :, :] @ jacobians(cfg, q)
    return stack_leg_rows(cfg, r, jw)


def contact_bias_mixed(cfg: RobotConfig, p_base, R_wb, q, u):
    """(.., 4, 3) foot bias accelerations Jdot u (u' = 0)."""
    del p_base
    return _flow(cfg, R_wb, q, u)["aF"]


def com_position(cfg: RobotConfig, p_base, R_wb, q):
    """(.., 3) whole-body CoM in world."""
    masses = _consts(cfg, q.dtype, q.device)["masses"]
    _, p_coms_b = link_kinematics(cfg, q)
    p_w = p_base[..., None, :] + _rotate(R_wb, p_coms_b)
    return (masses @ p_w) / total_mass(cfg)


def composite_inertia_com(cfg: RobotConfig, p_base, R_wb, q):
    """(.., 3, 3) whole-body rotational inertia about the CoM:
    sum_b [I_b^w + m_b (|r|^2 I - r r')], r = com_b - com."""
    c = _consts(cfg, q.dtype, q.device)
    masses = c["masses"]
    _, p_coms_b = link_kinematics(cfg, q)
    I_w = _inertia_world(cfg, R_wb, q)
    p_w = p_base[..., None, :] + _rotate(R_wb, p_coms_b)
    com = (masses @ p_w) / total_mass(cfg)
    r = p_w - com[..., None, :]
    r2 = (r * r).sum(dim=-1)
    steiner = (r2[..., None, None] * c["eye3"]
               - r[..., :, None] * r[..., None, :])
    return (I_w + masses[:, None, None] * steiner).sum(dim=-3)


def com_jacobian(cfg: RobotConfig, R_wb, q):
    """(.., 3, NV) CoM velocity Jacobian: v_com = J_com u."""
    masses = _consts(cfg, q.dtype, q.device)["masses"]
    Jv, _ = _jacobians(cfg, R_wb, q)
    return (masses @ Jv.flatten(-2)).unflatten(-1, (3, NV)) / total_mass(cfg)
