"""Convex SRB MPC over the gait horizon.

Port of apf_quadruped_tpu/planner.py.  Per replan: the gait supplies the
contact schedule, the navigation layer the footholds and the CoM goal;
the per-knot linearized SRB dynamics, the friction pyramids (masked by the
stance schedule) and the optional base-box / base-accel rows make one
StageQP per scenario, solved in one batched call of the Riccati interior
point — or, condensed over the horizon, one dense QP in the stacked forces.
Gait switching changes data, never shapes.

Backends (MpcConfig.backend), resolved by `effective_backend` from the
config and the tensors' device:
  * "riccati_resident": the whole IPM as one CUDA kernel
    (ops/cuda_riccati.py); on CPU tensors its plain version runs instead;
  * "riccati_fused": the same IPM with each pass of an iteration a CUDA
    kernel of its own (ops/cuda_riccati.solve_stage_qp_fused), kept as the
    resident kernel's cross-check; with base_box or base_acc it resolves
    to "riccati_resident", as the fused passes have no such rows;
  * "riccati": the IPM as plain PyTorch (ops/riccati.py);
  * "condensed": the states eliminated, a dense QP in U = [u_0..u_{H-1}]
    (n = 12H) through ops.qpsolve.solve_qp, kept to cross-validate the
    base_box / base_acc rows; it ignores warm starts and sqp_iters;
  * "auto": "riccati_resident" on a CUDA device, "riccati" on the CPU.

On the card a plan is one replay of its captured CUDA graph
(runtime/graph.call: the counterpart of the JAX package's jitted `plan`),
bit for bit the eager body `_plan_eager`, which the CPU runs.  The
constants a plan reads are built once per (cfg, dtype, device).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from ._device import constant
from ._precision import highest_precision
from .config import EngineConfig
from .models import srb
from .ops.cuda_riccati import solve_stage_qp_fused, solve_stage_qp_resident
from .ops.qpsolve import QPData, QPSolution, _solve_qp_eager
from .ops.riccati import StageQP, WarmStart, solve_stage_qp
from .runtime import graph, profiling

ROWS_PER_FOOT = 6   # fz<=fmax, -fz<=-fmin, +-fx-mu fz<=0, +-fy-mu fz<=0


class MpcRefs(NamedTuple):
    """Per-knot references and schedule feeding one MPC solve."""

    contacts: torch.Tensor   # (.., H, 4) stance masks
    feet_w: torch.Tensor     # (.., H, 4, 3) foothold positions (world)
    x_ref: torch.Tensor      # (.., H, NX) state references
    yaw_ref: torch.Tensor    # (..,) linearization yaw
    # optional (.., H, 4, 3, 3) terrain-aligned cone bases (columns t1, t2,
    # n); None = world-z cones.  Realized as a change of force variables
    # (see _rotate_B), so the solver's pyramid block is unchanged.
    cone_rot: torch.Tensor | None = None


class MpcPlan(NamedTuple):
    forces: torch.Tensor     # (.., H, 4, 3) planned contact forces
    states: torch.Tensor     # (.., H, NX) predicted state trajectory
    sol: QPSolution          # solver diagnostics (converged, gap, ...)


def foothold_schedule(feet_now_w, step_targets_w, contacts):
    """(.., H, 4, 3) per-knot foot positions: a leg keeps its current world
    position until its first swing knot in the horizon, then sits at its
    step target."""
    swung = torch.cumsum(1.0 - contacts, dim=-2) > 0         # (.., H, 4)
    return torch.where(swung[..., None], step_targets_w[..., None, :, :],
                       feet_now_w[..., None, :, :])


def reference_trajectory(cfg: EngineConfig, rpy0, com0, com_des, yaw_des,
                         horizon_T):
    """(.., H, NX) linear CoM ramp to the goal at standing height."""
    H = cfg.mpc.horizon
    dtype, dev = com0.dtype, com0.device
    tau = torch.arange(1, H + 1, dtype=dtype, device=dev) / H
    com_k = com0[..., None, :] + (com_des - com0)[..., None, :] * tau[..., None]
    v_ref = (com_des - com0) / horizon_T[..., None]
    zero = torch.zeros_like(yaw_des)
    rpy_k = torch.stack([zero, zero, yaw_des], dim=-1)
    x = torch.zeros(com_k.shape[:-1] + (srb.NX,), dtype=dtype, device=dev)
    x[..., 0:3] = rpy_k[..., None, :]
    x[..., 3:6] = com_k
    x[..., 9:12] = v_ref[..., None, :]
    x[..., 12] = 1.0
    return x


def _rotate_B(B, cone_rot):
    """u_world = C u_local folded into the input matrix:
    B_local = B_world @ blockdiag(C_1..C_4) per knot."""
    Bl = B.reshape(B.shape[:-1] + (4, 3))
    Bl = torch.einsum("...xlj,...lji->...xli", Bl, cone_rot)
    return Bl.reshape(B.shape)


def _forces_to_world(u, cone_rot):
    """u: (.., H, 12) local-basis forces -> world: f_w = C @ f_l per leg."""
    ul = u.reshape(u.shape[:-1] + (4, 3))
    return torch.einsum("...lji,...li->...lj", cone_rot, ul).reshape(u.shape)


def _forces_to_local(u, cone_rot):
    """Inverse of _forces_to_world: f_l = C' f_w per leg."""
    uw = u.reshape(u.shape[:-1] + (4, 3))
    return torch.einsum("...lji,...lj->...li", cone_rot, uw).reshape(u.shape)


BACKENDS = ("auto", "riccati", "riccati_resident", "riccati_fused",
            "condensed")


def effective_backend(cfg: EngineConfig, device) -> str:
    """The backend plan() uses for tensors on `device`."""
    backend = cfg.mpc.backend
    if backend not in BACKENDS:
        raise ValueError(f"unknown MpcConfig.backend {backend!r}")
    if backend == "riccati_fused" and (cfg.mpc.base_box or cfg.mpc.base_acc):
        return "riccati_resident"
    if backend == "auto":
        on_gpu = torch.device(device).type == "cuda"
        return "riccati_resident" if on_gpu else "riccati"
    return backend


def _pyramid_constants(cfg: EngineConfig):
    """Static friction-pyramid data (identical at every knot; only the
    stance mask is per-scenario data).  Returns numpy (24, 12) block and
    (24,) rhs."""
    mu = cfg.mpc.mu
    rows = []
    rhs = []
    for i in range(4):
        def row(cx, cy, cz, r):
            v = [0.0] * 12
            v[3 * i + 0] = cx
            v[3 * i + 1] = cy
            v[3 * i + 2] = cz
            rows.append(v)
            rhs.append(r)

        row(0.0, 0.0, 1.0, cfg.mpc.fz_max)     # fz <= fz_max
        row(0.0, 0.0, -1.0, -cfg.mpc.fz_min)   # -fz <= -fz_min
        row(1.0, 0.0, -mu, 0.0)                # fx - mu fz <= 0
        row(-1.0, 0.0, -mu, 0.0)
        row(0.0, 1.0, -mu, 0.0)
        row(0.0, -1.0, -mu, 0.0)
    return np.asarray(rows), np.asarray(rhs)


def plan(cfg: EngineConfig, state0, refs: MpcRefs,
         warm: WarmStart | None = None) -> MpcPlan:
    """One batched MPC solve.

    state0: (.., NX) packed SRB state (srb.pack_state); refs: contact and
    foothold schedules, state references.  warm: optional WarmStart from
    the previous replan (world-frame forces).  Runs with TF32 off.  On
    CUDA tensors a replay of the plan's graph, captured per configuration,
    backend and layout of (state0, refs, warm); on the CPU the eager body.
    """
    if state0.device.type == "cuda":
        backend = effective_backend(cfg, state0.device)
        if backend == "condensed":
            warm = None     # it takes no warm start: one graph serves both
        return graph.call(("plan", cfg, backend),
                          lambda args: _plan_eager(cfg, *args),
                          (state0, refs, warm))
    return _plan_eager(cfg, state0, refs, warm)


def _plan_eager(cfg: EngineConfig, state0, refs: MpcRefs,
                warm: WarmStart | None = None) -> MpcPlan:
    """plan's body, run op by op."""
    backend = effective_backend(cfg, state0.device)
    with highest_precision():
        if backend == "condensed":
            return _plan_condensed(cfg, state0, refs)
        return _plan_riccati(cfg, state0, refs, backend, warm)


@functools.lru_cache(maxsize=None)
def _mpc_costs(cfg: EngineConfig, dtype, device=None):
    mpc = cfg.mpc
    return torch.tensor([mpc.w_att] * 3 + [mpc.w_pos] * 3 + [mpc.w_omega] * 3
                        + [mpc.w_vel] * 3 + [0.0], dtype=dtype, device=device)


@functools.lru_cache(maxsize=None)
def _pyramid_tensors(cfg: EngineConfig, dtype, device):
    """The per-knot pyramid block G (24, 12) and rhs h (24,)."""
    blk, rhs_blk = _pyramid_constants(cfg)
    return (torch.as_tensor(blk, dtype=dtype, device=device),
            torch.as_tensor(rhs_blk, dtype=dtype, device=device))


@functools.lru_cache(maxsize=None)
def _condensed_pyramid(cfg: EngineConfig, dtype, device):
    """The pyramids over the horizon, kron(I_H, G) and tile(h, H)."""
    blk, rhs_blk = _pyramid_constants(cfg)
    Hh = cfg.mpc.horizon
    return (torch.as_tensor(np.kron(np.eye(Hh), blk), dtype=dtype,
                            device=device),
            torch.as_tensor(np.tile(rhs_blk, Hh), dtype=dtype,
                            device=device))


@functools.lru_cache(maxsize=None)
def _base_box_rows(dtype, device):
    """Cx (6, NX) of the base_box state rows: +-(roll, pitch, z)."""
    Cx_np = np.zeros((6, srb.NX))
    for i, d in enumerate((0, 1, 5)):                  # roll, pitch, z
        Cx_np[i, d] = 1.0
        Cx_np[3 + i, d] = -1.0
    return torch.as_tensor(Cx_np, dtype=dtype, device=device)


def _acc_rhs(cfg: EngineConfig, dtype, device):
    """The base_acc rows' bounds (6,): angular, then linear, times dt."""
    mpc = cfg.mpc
    return constant((mpc.acc_ang_max,) * 3 + (mpc.acc_lin_max,) * 3, dtype,
                    device) * mpc.dt


def _linearizations(cfg: EngineConfig, refs: MpcRefs):
    Hh = cfg.mpc.horizon
    yaw = torch.broadcast_to(refs.yaw_ref[..., None],
                             refs.yaw_ref.shape + (Hh,))
    return srb.linearize_discrete(cfg.robot, yaw, refs.x_ref[..., 3:6],
                                  refs.feet_w, refs.contacts, cfg.mpc.dt)


def _sqp_relinearize(cfg: EngineConfig, state0, refs: MpcRefs, sol):
    """Re-linearize the SRB dynamics around the predicted trajectory, with
    the exact nonlinear one-step defect c_k = f(x_k, u_k) - A x_k - B u_k
    folded into the affine carrier column of A (Gauss-Newton SQP)."""
    dt = cfg.mpc.dt
    xs = torch.cat([state0[..., None, :], sol.x[..., :-1, :]], dim=-2)
    A, B = srb.linearize_discrete(cfg.robot, xs[..., 2], xs[..., 3:6],
                                  refs.feet_w, refs.contacts, dt)
    forces = (sol.u.reshape(sol.u.shape[:-1] + (4, 3))
              * refs.contacts[..., None])
    rpy, r, om, v = srb.unpack_state(xs)
    d_rpy, d_r, d_om, d_v = srb.srb_derivative(
        cfg.robot, rpy, r, om, v, refs.feet_w, forces)
    dx = torch.cat([d_rpy, d_r, d_om, d_v, torch.zeros_like(xs[..., 12:13])],
                   dim=-1)
    f_nl = xs + dt * dx                              # exact Euler step
    c = (f_nl - torch.einsum("...ij,...j->...i", A, xs)
         - torch.einsum("...ij,...j->...i", B, sol.u))
    A = A.clone()
    A[..., :, 12] += c
    return A, B


def stage_qp(cfg: EngineConfig, state0, refs: MpcRefs, A=None,
             B=None) -> StageQP:
    """The StageQP plan() solves: costs, friction pyramids under the
    stance masks, and the opt-in base_box state rows and base_acc accel
    rows.  (A, B) default to the linearization around the references;
    with refs.cone_rot, B is taken into the cone basis."""
    mpc = cfg.mpc
    dtype, dev = state0.dtype, state0.device
    if A is None:
        A, B = _linearizations(cfg, refs)
    if refs.cone_rot is not None:
        B = _rotate_B(B, refs.cone_rot)
    q_diag = _mpc_costs(cfg, dtype, dev)
    mask = torch.repeat_interleave(refs.contacts, ROWS_PER_FOOT, dim=-1)

    # opt-in BaseRom box (towr base_motion_constraint.cc:46-55: roll and
    # pitch in +-dev_rad, base z in [z0 - below, z0 + above]) as state rows
    Cx = cx = mask_x = None
    if mpc.base_box:
        Cx = _base_box_rows(dtype, dev)
        z0 = state0[..., 5]
        dev_rad = constant(mpc.base_dev_rad, dtype, dev)
        his = torch.stack([dev_rad + 0.0 * z0, dev_rad + 0.0 * z0,
                           z0 + mpc.base_z_above], dim=-1)
        los = torch.stack([-dev_rad + 0.0 * z0, -dev_rad + 0.0 * z0,
                           z0 - mpc.base_z_below], dim=-1)
        cx1 = torch.cat([his, -los], dim=-1)           # (.., 6)
        cx = torch.broadcast_to(cx1[..., None, :],
                                state0.shape[:-1] + (mpc.horizon, 6))
        mask_x = torch.ones_like(cx)

    # base-acceleration bounds (towr BaseAcc analogue) as per-knot input
    # rows derived inside the solver (StageQP.acc_rhs)
    acc_rhs = _acc_rhs(cfg, dtype, dev) if mpc.base_acc else None
    G, h = _pyramid_tensors(cfg, dtype, dev)
    return StageQP(
        A=A, B=B, Q=torch.diag(q_diag), qlin=-refs.x_ref * q_diag,
        R=mpc.w_force * torch.eye(srb.NU, dtype=dtype, device=dev),
        G=G, h=h, mask=mask, x0=state0, Cx=Cx, cx=cx, mask_x=mask_x,
        acc_rhs=acc_rhs)


def _plan_riccati(cfg: EngineConfig, state0, refs: MpcRefs, backend: str,
                  warm: WarmStart | None = None) -> MpcPlan:
    """The plan through a Riccati backend; with profiling.marks on, a stage
    mark before the packing (linearizations, stage_qp, the frame
    rotations), each solver call and its unpacking, and at the end."""
    profiling.mark("plan.pack", state0)
    solver = {"riccati_resident": solve_stage_qp_resident,
              "riccati_fused": solve_stage_qp_fused,
              "riccati": solve_stage_qp}[backend]

    def solve(A, B, warm):
        if refs.cone_rot is not None and warm is not None:
            # warm forces arrive in the world frame
            warm = warm._replace(u=_forces_to_local(warm.u, refs.cone_rot))
        qp = stage_qp(cfg, state0, refs, A, B)
        profiling.mark("plan.ipm", state0)
        sol = solver(qp, cfg.solver, warm)
        profiling.mark("plan.unpack", state0)
        if refs.cone_rot is not None:
            sol = sol._replace(u=_forces_to_world(sol.u, refs.cone_rot))
        return sol

    sol = solve(*_linearizations(cfg, refs), warm)
    ones = torch.ones(state0.shape[:-1], dtype=torch.bool,
                      device=state0.device)
    for _ in range(max(1, cfg.mpc.sqp_iters) - 1):   # SQP outer loop
        profiling.mark("plan.pack", state0)
        A, B = _sqp_relinearize(cfg, state0, refs, sol)
        # each SQP re-solve warm-starts from the previous inner solution
        sol = solve(A, B, WarmStart(u=sol.u, z=sol.z, s=sol.s, valid=ones))
    diag = QPSolution(x=sol.u.reshape(sol.u.shape[:-2] + (-1,)),
                      y=torch.zeros_like(state0[..., 0:1]),
                      z=sol.z.reshape(sol.z.shape[:-2] + (-1,)),
                      s=sol.s.reshape(sol.s.shape[:-2] + (-1,)),
                      converged=sol.converged, iters=sol.iters,
                      gap=sol.gap, res_norm=sol.res_norm)
    profiling.mark("plan.end", state0)
    return MpcPlan(forces=sol.u.reshape(sol.u.shape[:-1] + (4, 3)),
                   states=sol.x, sol=diag)


def _condense(A, B, x0):
    """Condense x_{k+1} = A_k x_k + B_k u_k over the horizon.

    A: (.., H, NX, NX), B: (.., H, NX, NU), x0: (.., NX).  Returns the free
    response Sx_x0 (.., H, NX) and Su (.., H, NX, H*NU) with
    x_{k+1} = Sx_x0[k] + Su[k] @ U, carried as the running row [free,
    forced]: one (NX x NX) @ (NX x H*NU) product per knot.
    """
    Hh, NU = A.shape[-3], B.shape[-1]
    free = x0
    forced = torch.zeros(x0.shape + (Hh * NU,), dtype=x0.dtype,
                         device=x0.device)
    frees, forceds = [], []
    for k in range(Hh):
        free = torch.einsum("...ij,...j->...i", A[..., k, :, :], free)
        forced = A[..., k, :, :] @ forced
        forced[..., k * NU:(k + 1) * NU] += B[..., k, :, :]
        frees.append(free)
        forceds.append(forced)
    return torch.stack(frees, dim=-2), torch.stack(forceds, dim=-3)


def _plan_condensed(cfg: EngineConfig, state0, refs: MpcRefs) -> MpcPlan:
    """The dense QP in the stacked forces: cost sum_k |x_{k+1} - xref_k|_Q^2
    + w_force |U|^2 over the condensed prediction, the friction pyramids as
    the constant block diagonal kron(I_H, pyramid) under the stance masks,
    and the base_box / base_acc rows written on U."""
    mpc = cfg.mpc
    Hh, NX, NU = mpc.horizon, srb.NX, srb.NU
    dtype, dev = state0.dtype, state0.device
    batch = state0.shape[:-1]
    opts = dict(dtype=dtype, device=dev)

    A, B = _linearizations(cfg, refs)
    if refs.cone_rot is not None:
        B = _rotate_B(B, refs.cone_rot)          # solve in the cone basis
    Sx_x0, Su = _condense(A, B, state0)          # (.., H, NX), (.., H, NX, H*NU)

    q_diag = _mpc_costs(cfg, dtype, dev)
    err0 = Sx_x0 - refs.x_ref
    SuQ = Su * q_diag[:, None]
    P = torch.einsum("...hni,...hnj->...ij", SuQ, Su)
    P = P + mpc.w_force * torch.eye(Hh * NU, **opts)
    qv = torch.einsum("...hni,...hn->...i", SuQ, err0)

    m_total = Hh * 4 * ROWS_PER_FOOT
    G_all, h_all = _condensed_pyramid(cfg, dtype, dev)
    G = torch.broadcast_to(G_all, batch + (m_total, Hh * NU))
    h = torch.broadcast_to(h_all, batch + (m_total,))
    ineq_mask = torch.repeat_interleave(refs.contacts, ROWS_PER_FOOT,
                                        dim=-1).reshape(batch + (m_total,))
    Gs, hs, ms = [G], [h], [ineq_mask]

    if mpc.base_box:
        # towr BaseMotionConstraint (base_motion_constraint.cc:46-55):
        # roll/pitch in +-dev_rad, base z in [z0 - below, z0 + above],
        # exact on the condensed form x_k = Sx_x0 + Su U: two rows on U per
        # knot per dim
        dims = constant((0, 1, 5), torch.int64, dev)    # roll, pitch, z
        z0 = state0[..., 5]
        dev_rad = constant(mpc.base_dev_rad, dtype, dev)
        los = torch.stack([-dev_rad + 0.0 * z0, -dev_rad + 0.0 * z0,
                           z0 - mpc.base_z_below], dim=-1)
        his = torch.stack([dev_rad + 0.0 * z0, dev_rad + 0.0 * z0,
                           z0 + mpc.base_z_above], dim=-1)
        Su_d, Sx_d = Su.index_select(-2, dims), Sx_x0.index_select(-1, dims)
        n_box = Hh * 2 * len(dims)
        Gs.append(torch.cat([Su_d, -Su_d], dim=-2)
                  .reshape(batch + (n_box, Hh * NU)))
        hs.append(torch.cat([his[..., None, :] - Sx_d,
                             Sx_d - los[..., None, :]], dim=-1)
                  .reshape(batch + (n_box,)))
        ms.append(torch.ones(batch + (n_box,), **opts))

    if mpc.base_acc:
        # per-knot input rows +-B_k[6:12,:] u_k <= acc_rhs -+ A_k[6:12,12]
        # (StageQP.acc_rhs), block diagonal on the stacked U
        SB, off = B[..., 6:12, :], A[..., 6:12, 12]
        rhs6 = _acc_rhs(cfg, dtype, dev)
        Gacc = torch.einsum("hk,...hrc->...hrkc", torch.eye(Hh, **opts),
                            SB).reshape(batch + (Hh * 6, Hh * NU))
        Gs += [Gacc, -Gacc]
        hs += [(rhs6 - off).reshape(batch + (Hh * 6,)),
               (rhs6 + off).reshape(batch + (Hh * 6,))]
        ms.append(torch.ones(batch + (Hh * 12,), **opts))

    # no equality rows (swing forces are decoupled and regularized to zero)
    zeros1 = torch.zeros(batch + (1,), **opts)
    qp = QPData(P=P, q=qv, A=torch.zeros(batch + (1, Hh * NU), **opts),
                b=zeros1, G=torch.cat(Gs, dim=-2), h=torch.cat(hs, dim=-1),
                eq_mask=zeros1, ineq_mask=torch.cat(ms, dim=-1))
    sol = _solve_qp_eager(qp, cfg.solver)

    states = Sx_x0 + torch.einsum("...hnm,...m->...hn", Su, sol.x)
    U_knots = sol.x.reshape(batch + (Hh, NU))
    if refs.cone_rot is not None:
        U_knots = _forces_to_world(U_knots, refs.cone_rot)
    return MpcPlan(forces=U_knots.reshape(batch + (Hh, 4, 3)),
                   states=states, sol=sol)
