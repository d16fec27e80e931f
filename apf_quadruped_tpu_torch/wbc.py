"""Whole-body tracking QP — one mask-parameterized formulation.

Port of apf_quadruped_tpu/wbc.py, batched over scenarios.  Decision
x in R^30 = [udot(18); f(12)]; the stance mask is data, the shapes never
change:

  cost   ||W(x) - W_com_des||^2_q1 + x' reg x + w_sw ||a_sw(x) - a_sw_des||^2
         (W(x) the CoM wrench of the forces, W_com_des = K_com dx + D_com dv
         + m g + M_c a_des; the swing-foot term is a soft cost of weight
         slack_weight_trot, or slack_weight_crawl in crawl phases)
  eq     6 floating-base rows (M udot + h - Jc' f)[0:6] = 0,
         12 stance no-slip rows Jc udot = -Jdot u, 12 swing force-zero rows
  ineq   20 friction-pyramid rows on the terrain basis, 24 torque-limit
         rows, 24 joint-acceleration rows from the position limits

and the torques are tau = (M udot + h - Jc' f)[6:18].  The JAX module
writes the blocks with .at[].set() chains; here they are concatenated,
or assigned into fresh tensors, batch first.  The QP goes to
ops/qpsolve.solve_qp's body, whose SPD solves run on the CUDA kernels on
the card.  On the card a tick is one replay of its captured CUDA graph
(runtime/graph.call: the counterpart of the JAX package's jitted `solve`),
bit for bit the eager body `_solve_eager`, which the CPU runs; inside the
closed loop's tick graph the body runs as part of that graph.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from ._precision import highest_precision
from .config import EngineConfig
from .models import rbd
from .models.dogbot import joint_limits
from .ops.qpsolve import QPData, QPSolution, _solve_qp_eager
from .ops.rotations import rot_to_rpy, skew
from .runtime import graph, profiling

NX = 30      # 18 accelerations + 12 forces
NEQ = 30     # 6 dynamics + 12 no-slip + 12 swing-force-zero
NINEQ = 68   # 20 pyramid + 24 torque + 24 joint-accel


class WbcState(NamedTuple):
    """Robot state feeding one batched WBC solve."""

    p_base: torch.Tensor     # (.., 3) world base position
    R_wb: torch.Tensor       # (.., 3, 3) world_R_base
    q: torch.Tensor          # (.., 12) joint angles (leg-major)
    u: torch.Tensor          # (.., 18) mixed generalized velocity
    contact: torch.Tensor    # (.., 4) stance mask (1 = stance)
    # (..,) bool or a Python bool: crawl phase, selects the crawl swing
    # weight instead of the trot weight (data, not shape)
    crawl: torch.Tensor | bool = False
    # (.., 4, 3, 3) terrain-aligned friction-cone basis per foot (columns
    # t1, t2, n); None = world-z cones (identity)
    cone_rot: torch.Tensor | None = None


class WbcRefs(NamedTuple):
    """Tracking references at the current tick."""

    com_pos: torch.Tensor     # (.., 3)
    com_vel: torch.Tensor     # (.., 3)
    com_acc: torch.Tensor     # (.., 3)
    rpy: torch.Tensor         # (.., 3)
    omega: torch.Tensor       # (.., 3) desired angular velocity (world)
    omega_dot: torch.Tensor   # (.., 3)
    swing_pos: torch.Tensor   # (.., 4, 3) desired swing-foot positions
    swing_vel: torch.Tensor   # (.., 4, 3)
    swing_acc: torch.Tensor   # (.., 4, 3)


class WbcOutput(NamedTuple):
    tau: torch.Tensor         # (.., 12) joint torques
    udot: torch.Tensor        # (.., 18)
    forces: torch.Tensor      # (.., 4, 3)
    sol: QPSolution
    # the tick's dynamics evaluation, reused by the momentum observer
    M: torch.Tensor | None = None       # (.., 18, 18)
    h_bias: torch.Tensor | None = None  # (.., 18)
    Jc: torch.Tensor | None = None      # (.., 12, 18)


@functools.lru_cache(maxsize=None)
def _consts(cfg: EngineConfig, dtype, device):
    """Constant blocks, built once per device."""
    mu = cfg.wbc.mu
    cfr = np.array([[1.0, 0.0, -mu], [0.0, 1.0, -mu], [-1.0, 0.0, -mu],
                    [0.0, -1.0, -mu], [0.0, 0.0, -1.0]])
    qmin, qmax = joint_limits(cfg.robot)
    g_acc = np.zeros((12, NX))
    g_acc[:, 6:18] = np.eye(12)
    f_eye = np.zeros((12, NX))
    f_eye[:, 18:30] = np.eye(12)
    lin = np.tile(np.eye(3), (1, 4))                       # (3, 12)

    def t(v):
        return torch.as_tensor(np.asarray(v, np.float64), dtype=dtype,
                               device=device)
    return dict(cfr=t(cfr), qmin=t(qmin), qmax=t(qmax), g_acc=t(g_acc),
                f_eye=t(f_eye), lin=t(lin), eye3=t(np.eye(3)),
                leg_block=t(np.eye(4)[:, None, :, None]),
                eye12=t(np.eye(12)), eye_nx=t(np.eye(NX)),
                g6=t([0.0, 0.0, rbd.GRAVITY, 0.0, 0.0, 0.0]))


def _mv(M, v):
    return (M @ v.unsqueeze(-1)).squeeze(-1)


def _mtv(M, v):
    return (v.unsqueeze(-2) @ M).squeeze(-2)


def _x6(c, xbc):
    """[[I, skew(xbc)'], [0, I]] (.., 6, 6)."""
    batch = xbc.shape[:-1]
    X6 = torch.zeros(batch + (6, 6), dtype=xbc.dtype, device=xbc.device)
    X6[..., 0:3, 0:3] = c["eye3"]
    X6[..., 0:3, 3:6] = skew(xbc).transpose(-1, -2)
    X6[..., 3:6, 3:6] = c["eye3"]
    return X6


def _solve(A, B):
    # solve_ex: no host sync for an error check (a singular lane gives
    # non-finite values, which the QP's quarantine handles)
    return torch.linalg.solve_ex(A, B)[0]


def _exact_regularizer(cfg, c, st, M, com, v_com):
    """The reference-exact ||x||^2 regularizer over CoM-frame
    accelerations [udot_com(6); qdd(12)]: x' reg x + reg_lin' x."""
    batch = st.q.shape[:-1]
    opts = dict(dtype=st.q.dtype, device=st.q.device)
    xbc = com - st.p_base
    X6 = _x6(c, xbc)
    Mb, Mbj = M[..., 0:6, 0:6], M[..., 0:6, 6:18]
    MbMj = _solve(Mb, Mbj)
    Cmap = torch.zeros(batch + (6, 18), **opts)
    Cmap[..., 0:3, 0:3] = c["eye3"]
    Cmap[..., 0:3, 3:6] = skew(xbc).transpose(-1, -2)
    Cmap[..., 3:6, 3:6] = c["eye3"]
    Cmap[..., :, 6:18] = X6 @ MbMj
    # dCmap u: the affine CoM-acceleration offset (Tdot terms)
    xbc_dot = v_com - st.u[..., 0:3]
    m_tot = rbd.total_mass(cfg.robot)
    dX6 = torch.zeros(batch + (6, 6), **opts)
    dX6[..., 0:3, 3:6] = skew(xbc_dot).transpose(-1, -2)
    mdr_hat = skew(m_tot * xbc_dot)
    dMb = torch.zeros(batch + (6, 6), **opts)
    dMb[..., 0:3, 3:6] = mdr_hat.transpose(-1, -2)
    dMb[..., 3:6, 0:3] = mdr_hat
    dJs6 = dX6 @ MbMj - X6 @ _solve(Mb, dMb @ MbMj)
    dCmap = torch.zeros(batch + (6, 18), **opts)
    dCmap[..., 0:3, 3:6] = skew(xbc_dot).transpose(-1, -2)
    dCmap[..., :, 6:18] = dJs6
    c6 = _mv(dCmap, st.u)
    reg = torch.zeros(batch + (NX, NX), **opts)
    reg[..., 0:18, 0:18] = Cmap.transpose(-1, -2) @ Cmap
    reg[..., 6:18, 6:18] += c["eye12"]
    reg[..., 18:30, 18:30] = c["eye12"]
    reg_lin = torch.cat([_mtv(Cmap, c6), torch.zeros(batch + (12,), **opts)],
                        dim=-1)
    return reg, reg_lin


def _pyramid_rows(c, cone_rot, batch):
    """(.., 20, 12) friction-pyramid rows, five per foot on the foot's
    basis: [c1 c2 c3] -> [c1 c2 c3] C_i' (C_i = I gives the world rows)."""
    if cone_rot is None:
        blk = c["cfr"].expand(batch + (4, 5, 3))
    else:
        blk = c["cfr"] @ cone_rot.transpose(-1, -2)
    return (blk[..., None, :] * c["leg_block"]).reshape(batch + (20, 12))


def _build_qp(cfg: EngineConfig, st: WbcState, ref: WbcRefs):
    """The QP, and (M, h, Jc, com) for the torque map and the observer."""
    w = cfg.wbc
    dtype, dev = st.q.dtype, st.q.device
    c = _consts(cfg, dtype, dev)
    batch = st.q.shape[:-1]
    c4 = st.contact
    robot = cfg.robot

    M, h = rbd.mass_and_bias(robot, st.p_base, st.R_wb, st.q, st.u)
    Jc = rbd.contact_jacobian_mixed(robot, st.p_base, st.R_wb, st.q)
    jdu = rbd.contact_bias_mixed(robot, st.p_base, st.R_wb, st.q,
                                 st.u).reshape(batch + (12,))
    com = rbd.com_position(robot, st.p_base, st.R_wb, st.q)
    Jcom = rbd.com_jacobian(robot, st.R_wb, st.q)
    feet = rbd.foot_positions_world(robot, st.p_base, st.R_wb, st.q)

    # ---- cost: force -> wrench about the CoM ----------------------------
    lever = feet - com[..., None, :]                       # (.., 4, 3)
    Tf = torch.cat([c["lin"].expand(batch + (3, 12)),
                    skew(lever).transpose(-3, -2).reshape(batch + (3, 12))],
                   dim=-2)                                 # (.., 6, 12)
    Ts = torch.cat([torch.zeros(batch + (6, 18), dtype=dtype, device=dev),
                    Tf], dim=-1)                           # (.., 6, 30)
    rpy_now = rot_to_rpy(st.R_wb)
    dx = torch.cat([ref.com_pos - com, ref.rpy - rpy_now], dim=-1)
    v_com = _mv(Jcom, st.u)
    dv = torch.cat([ref.com_vel - v_com, ref.omega - st.u[..., 3:6]], dim=-1)
    m_tot = rbd.total_mass(robot)
    I_com = rbd.composite_inertia_com(robot, st.p_base, st.R_wb, st.q)
    Mc_a = torch.cat([m_tot * ref.com_acc, _mv(I_com, ref.omega_dot)],
                     dim=-1)                               # M_c a_des
    Wdes = w.k_com * dx + w.d_com * dv + m_tot * c["g6"] + Mc_a

    if w.ref_exact:
        reg, reg_lin = _exact_regularizer(cfg, c, st, M, com, v_com)
    else:
        reg, reg_lin = c["eye_nx"], torch.zeros(batch + (NX,), dtype=dtype,
                                                device=dev)
    Tst = Ts.transpose(-1, -2)
    P = w.q1 * (Tst @ Ts) + reg
    qv = -w.q1 * _mv(Tst, Wdes) + reg_lin

    # swing-foot tracking as a soft cost on rows Jc udot = a_sw_des - jdu
    a_sw_des = (ref.swing_acc
                + w.kd_swing * (ref.swing_vel
                                - _mv(Jc, st.u).reshape(batch + (4, 3)))
                + w.kp_swing * (ref.swing_pos - feet))
    st_mask = c4.repeat_interleave(3, dim=-1)              # (.., 12)
    sw_mask = 1.0 - st_mask
    A_sw = torch.cat([Jc, torch.zeros(batch + (12, 12), dtype=dtype,
                                      device=dev)], dim=-1)
    b_sw = a_sw_des.reshape(batch + (12,)) - jdu
    if isinstance(st.crawl, torch.Tensor):
        wsw = torch.where(st.crawl, w.slack_weight_crawl,
                          w.slack_weight_trot).to(dtype)[..., None]
    else:
        wsw = w.slack_weight_crawl if st.crawl else w.slack_weight_trot
    A_swt = A_sw.transpose(-1, -2)
    P = P + (wsw[..., None] if isinstance(wsw, torch.Tensor) else wsw) * (
        A_swt @ (sw_mask[..., None] * A_sw))
    qv = qv - wsw * _mv(A_swt, sw_mask * b_sw)

    # ---- equalities -------------------------------------------------------
    zeros12 = torch.zeros(batch + (12, 12), dtype=dtype, device=dev)
    A = torch.cat([
        torch.cat([M[..., 0:6, :], -Jc[..., :, 0:6].transpose(-1, -2)], -1),
        torch.cat([Jc, zeros12], dim=-1),
        c["f_eye"].expand(batch + (12, NX))], dim=-2)
    b = torch.cat([-h[..., 0:6], -jdu, torch.zeros_like(jdu)], dim=-1)
    if w.ref_exact and w.ref_exact_swing_b0:
        # the reference's trot-swing QP drops its known term (b = 0)
        # whenever legs swing outside crawl
        trot_swing = c4.amin(dim=-1) < 0.5
        if isinstance(st.crawl, torch.Tensor):
            trot_swing = trot_swing & ~st.crawl
        elif st.crawl:
            trot_swing = torch.zeros_like(trot_swing)
        b = torch.where(trot_swing[..., None], torch.zeros_like(b), b)
    ones6 = torch.ones(batch + (6,), dtype=dtype, device=dev)
    eq_mask = torch.cat([ones6, st_mask, sw_mask], dim=-1)

    # ---- inequalities -----------------------------------------------------
    G_pyr = torch.cat([torch.zeros(batch + (20, 18), dtype=dtype, device=dev),
                       _pyramid_rows(c, st.cone_rot, batch)], dim=-1)
    G_tau = torch.cat([M[..., 6:18, :], -Jc[..., :, 6:18].transpose(-1, -2)],
                      dim=-1)
    g_acc = c["g_acc"].expand(batch + (12, NX))
    G = torch.cat([G_pyr, G_tau, -G_tau, g_acc, -g_acc], dim=-2)
    dt2 = 2.0 / (w.joint_dt ** 2)
    qd = st.u[..., 6:18]
    ddqmax = dt2 * (c["qmax"] - st.q - w.joint_dt * qd)
    ddqmin = dt2 * (c["qmin"] - st.q - w.joint_dt * qd)
    if w.qd_limit and not w.ref_exact:
        # joint velocity limits as acceleration bounds over one tick; a
        # joint already past a limit keeps the row pair feasible
        inv_dt = 1.0 / w.qd_dt
        ddqmax = torch.minimum(ddqmax, (robot.qd_max - qd) * inv_dt)
        ddqmin = torch.maximum(ddqmin, (-robot.qd_max - qd) * inv_dt)
        ddqmax = torch.maximum(ddqmax, ddqmin)
    hvec = torch.cat([torch.zeros(batch + (20,), dtype=dtype, device=dev),
                      robot.tau_max - h[..., 6:18],
                      robot.tau_max + h[..., 6:18], ddqmax, -ddqmin], dim=-1)
    pyr_mask = c4.repeat_interleave(5, dim=-1)
    ineq_mask = torch.cat([pyr_mask, torch.ones(batch + (48,), dtype=dtype,
                                                device=dev)], dim=-1)

    return (QPData(P=P, q=qv, A=A, b=b, G=G, h=hvec, eq_mask=eq_mask,
                   ineq_mask=ineq_mask), (M, h, Jc, com))


def solve(cfg: EngineConfig, st: WbcState, ref: WbcRefs) -> WbcOutput:
    """One batched WBC tick, with TF32 off for the whole tick (the QP data
    itself, not only the solve, needs full float32).  On CUDA tensors a
    replay of the tick's graph, captured per configuration and layout of
    (st, ref) (cone_rot None or not, crawl a tensor or a bool); on the CPU
    the eager body."""
    if st.q.device.type == "cuda":
        return graph.call(("wbc", cfg),
                          lambda args: _solve_eager(cfg, *args), (st, ref))
    return _solve_eager(cfg, st, ref)


def _solve_eager(cfg: EngineConfig, st: WbcState, ref: WbcRefs) -> WbcOutput:
    """solve's body, run op by op."""
    with highest_precision():
        return _solve_impl(cfg, st, ref)


def _solve_impl(cfg: EngineConfig, st: WbcState, ref: WbcRefs) -> WbcOutput:
    """The WBC tick: the QP's data, its solve, the torque map; with
    profiling.marks on, a stage mark before each and at the end."""
    profiling.mark("wbc.build", st.q)
    qp, (M, h, Jc, com) = _build_qp(cfg, st, ref)
    profiling.mark("wbc.qp", st.q)
    sol = _solve_qp_eager(qp, cfg.solver)
    profiling.mark("wbc.torque", st.q)
    udot, f = sol.x[..., 0:18], sol.x[..., 18:30]
    r = _mv(M, udot) + h - _mtv(Jc, f)
    tau = r[..., 6:18]
    if cfg.wbc.ref_exact:
        # the reference maps torques in CoM coordinates: tau_com =
        # r[6:18] + Tinv[0:6, 6:18]' r[0:6]
        c = _consts(cfg, r.dtype, r.device)
        xh = skew(com - st.p_base)
        Js6 = _x6(c, com - st.p_base) @ _solve(M[..., 0:6, 0:6],
                                               M[..., 0:6, 6:18])
        Tinv_bj = torch.cat([xh.transpose(-1, -2) @ Js6[..., 3:6, :]
                             - Js6[..., 0:3, :], -Js6[..., 3:6, :]], dim=-2)
        tau = tau + _mtv(Tinv_bj, r[..., 0:6])
    tau = torch.clamp(tau, -cfg.robot.tau_max, cfg.robot.tau_max)
    profiling.mark("wbc.end", st.q)
    return WbcOutput(tau=tau, udot=udot,
                     forces=f.reshape(f.shape[:-1] + (4, 3)), sol=sol,
                     M=M, h_bias=h, Jc=Jc)
