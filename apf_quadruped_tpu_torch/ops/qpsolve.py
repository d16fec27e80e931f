"""Batched dense Mehrotra predictor-corrector interior-point QP solver.

Port of apf_quadruped_tpu/ops/qpsolve.py, the solver of the whole-body QP
(n = 30 variables, p = 30 equality rows, m = 68 inequality rows in the
closed loop).  It solves

    min 1/2 x'Px + q'x   s.t.  Ax = b,  Gx <= h

for a batch of padded QPs at once: the inequality block is eliminated
analytically (W^-1 = diag(z/s)), the condensed SPD system
H = P + G' W^-1 G is factored by Cholesky, and the equalities go through
the Schur complement S_eq = A H^-1 A'.  A fixed number of iterations with
per-lane convergence masks replaces an early exit (a converged lane takes a
zero step), and the loop never reads a value back to the host.  Masked
inequality rows become 0'x <= 1 and masked equality rows 0'x = 0 with a
unit diagonal in the Schur complement.

On the card, in float32 and at the WBC's sizes (n <= 30, p <= 30, m <= 72:
ops/cuda_qp.takes, a rule on device, dtype and shape), the whole solve is
one launch of the resident QP kernel (ops/cuda_qp.py, csrc/resident_qp.cu).
Everything else runs `_solve_qp_impl` op by op, its SPD factor and solves
through ops/chol.py: the hand-written CUDA kernels for CUDA tensors (the
condensed planner's n = 12H, another dtype), the plain PyTorch version on
the CPU.  On the card a solve is one replay of its captured CUDA graph
(runtime/graph.call: the counterpart of the JAX package's jitted
`solve_qp`), bit for bit the eager body `_solve_qp_eager`, which the CPU
runs.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .._precision import highest_precision
from ..config import SolverConfig
from ..runtime import graph
from . import cuda_qp
from .chol import spd_factor, spd_solve


class QPData(NamedTuple):
    """One (possibly batched) QP in padded dense form."""

    P: torch.Tensor      # (..., n, n)
    q: torch.Tensor      # (..., n)
    A: torch.Tensor      # (..., p, n)
    b: torch.Tensor      # (..., p)
    G: torch.Tensor      # (..., m, n)
    h: torch.Tensor      # (..., m)
    eq_mask: torch.Tensor    # (..., p)
    ineq_mask: torch.Tensor  # (..., m)


class QPSolution(NamedTuple):
    x: torch.Tensor          # (..., n) primal
    y: torch.Tensor          # (..., p) equality multipliers
    z: torch.Tensor          # (..., m) inequality multipliers
    s: torch.Tensor          # (..., m) slacks
    converged: torch.Tensor  # (...,) bool — residuals below tolerance
    iters: torch.Tensor      # (...,) int32 — first iteration at which converged
    gap: torch.Tensor        # (...,) final duality measure s'z/m
    res_norm: torch.Tensor   # (...,) final max relative residual norm


def _apply_masks(qp: QPData) -> QPData:
    """Neutralize padded rows: masked ineq -> 0'x <= 1, masked eq -> 0'x = 0."""
    im, em = qp.ineq_mask, qp.eq_mask
    return qp._replace(G=qp.G * im[..., None],
                       h=torch.where(im > 0, qp.h, torch.ones_like(qp.h)),
                       A=qp.A * em[..., None], b=qp.b * em)


def _steplen(s, ds, z, dz, frac, mask):
    """Max alpha in (0, 1] keeping s + a ds > 0, z + a dz > 0 over REAL rows
    (padded rows can never throttle the step)."""
    def ratio(v, dv):
        neg = (dv < 0) & (mask > 0)
        r = torch.where(neg, -v / torch.where(neg, dv, -torch.ones_like(dv)),
                        torch.full_like(v, float("inf")))
        return r.amin(dim=-1)

    a = torch.minimum(ratio(s, ds), ratio(z, dz))
    return torch.clamp(frac * a, max=1.0)


def _mv(M, v):
    return (M @ v.unsqueeze(-1)).squeeze(-1)


def _mtv(M, v):
    return (v.unsqueeze(-2) @ M).squeeze(-2)


def solve_qp(qp: QPData, cfg: SolverConfig = SolverConfig()) -> QPSolution:
    """Batched Mehrotra predictor-corrector IPM with a fixed iteration
    count; any leading batch shape, dtype of qp.P.  Runs with TF32 off.
    On CUDA tensors a replay of the solve's graph, captured per
    configuration and layout of qp; on the CPU the eager body."""
    if qp.P.device.type == "cuda":
        return graph.call(("qp", cfg), lambda q: _solve_qp_eager(q, cfg), qp)
    return _solve_qp_eager(qp, cfg)


def _solve_qp_eager(qp: QPData, cfg: SolverConfig) -> QPSolution:
    """solve_qp's body: one launch of the resident QP kernel where
    cuda_qp.takes the QP, else `_solve_qp_impl` op by op."""
    if cuda_qp.takes(qp):
        return QPSolution(*cuda_qp.solve_qp_resident(qp, cfg))
    with highest_precision():
        return _solve_qp_impl(qp, cfg)


def _solve_qp_impl(qp: QPData, cfg: SolverConfig) -> QPSolution:
    qp = _apply_masks(qp)
    P, q, A, b, G, h = qp.P, qp.q, qp.A, qp.b, qp.G, qp.h
    dt, dev = P.dtype, P.device
    n, p = q.shape[-1], b.shape[-1]
    imask = qp.ineq_mask
    m_eff = torch.clamp(imask.sum(dim=-1), min=1.0)

    eye_n = torch.eye(n, dtype=dt, device=dev)
    eye_p = torch.eye(p, dtype=dt, device=dev)
    # padding eq rows get a unit Schur diagonal, real rows only eq_reg
    schur_diag = (cfg.eq_reg + (1.0 - qp.eq_mask))[..., None] * eye_p
    min_slack = cfg.min_slack
    At, Gt = A.transpose(-1, -2), G.transpose(-1, -2)

    def factor(W_inv):
        H = P + cfg.static_reg * eye_n + Gt @ (W_inv.unsqueeze(-1) * G)
        F_h = spd_factor(H)
        HiAt = spd_solve(F_h, At)                           # (..., n, p)
        S_eq = A @ HiAt + schur_diag
        return F_h, spd_factor(S_eq)

    def kkt_solve(F_h, F_s, W_inv, rhs_x, rhs_y):
        """Solve H dx + A'dy = rhs_x, A dx = rhs_y, then cfg.refine_steps
        rounds of iterative refinement against the unregularized H."""
        def solve_once(rx_, ry_):
            t = spd_solve(F_h, rx_)
            dy = spd_solve(F_s, _mv(A, t) - ry_)
            return t - spd_solve(F_h, _mv(At, dy)), dy

        def H_mv(v):
            return _mv(P, v) + _mtv(G, W_inv * _mv(G, v))

        dx, dy = solve_once(rhs_x, rhs_y)
        for _ in range(cfg.refine_steps):
            r1 = rhs_x - H_mv(dx) - _mv(At, dy)
            r2 = rhs_y - _mv(A, dx)
            ddx, ddy = solve_once(r1, r2)
            dx, dy = dx + ddx, dy + ddy
        return dx, dy

    # initial point: least squares with W = I, then slacks/duals shifted in
    W_one = torch.ones_like(h)
    F_h0, F_s0 = factor(W_one)
    x, y = kkt_solve(F_h0, F_s0, W_one, -q + _mtv(G, h), b)
    r0 = _mv(G, x) - h
    shift = torch.clamp(r0.amax(dim=-1, keepdim=True), min=0.0) + 1.0
    s = -r0 + shift
    z = torch.clamp(r0, min=0.0) + 1.0

    bnorm = 1.0 + torch.linalg.vector_norm(b, dim=-1)
    hnorm = 1.0 + torch.linalg.vector_norm(h, dim=-1)
    qnorm = 1.0 + torch.linalg.vector_norm(q, dim=-1)

    def residuals(x, y, z, s):
        rx = _mv(P, x) + q + _mv(At, y) + _mtv(G, z)
        return rx, _mv(A, x) - b, _mv(G, x) + s - h

    def res_norm(rx, ry, rz):
        return torch.maximum(
            torch.linalg.vector_norm(rx, dim=-1) / qnorm,
            torch.maximum(torch.linalg.vector_norm(ry, dim=-1) / bnorm,
                          torch.linalg.vector_norm(rz, dim=-1) / hnorm))

    done = torch.zeros(q.shape[:-1], dtype=torch.bool, device=dev)
    it_conv = torch.full(q.shape[:-1], cfg.iters, dtype=torch.int32,
                         device=dev)
    for it in range(cfg.iters):
        rx, ry, rz = residuals(x, y, z, s)
        mu = (s * z * imask).sum(dim=-1) / m_eff
        now_conv = (res_norm(rx, ry, rz) < cfg.reltol) & (mu < cfg.abstol)
        it_conv = it_conv.masked_fill(now_conv & ~done, it)
        done = done | now_conv

        z_safe = torch.clamp(z, min=min_slack)
        s_safe = torch.clamp(s, min=min_slack)
        # the clip guards H's conditioning only: the primal and
        # complementarity rows of the Newton step below stay exact
        W_inv = torch.clamp(z_safe / s_safe, 1.0 / cfg.w_clip, cfg.w_clip)
        F_h, F_s = factor(W_inv)

        def newton(rc):
            rhs_x = -rx - _mtv(G, W_inv * rz + rc / s_safe)
            dx, dy = kkt_solve(F_h, F_s, W_inv, rhs_x, -ry)
            ds = -rz - _mv(G, dx)                 # primal row, exact
            dz = (rc - z * ds) / s_safe           # complementarity row, exact
            return dx, dy, dz, ds

        # predictor (affine scaling step, sigma = 0)
        dx_a, dy_a, dz_a, ds_a = newton(-s * z)
        alpha_a = _steplen(s, ds_a, z, dz_a, 1.0, imask)[..., None]
        mu_aff = ((s + alpha_a * ds_a) * (z + alpha_a * dz_a)
                  * imask).sum(dim=-1) / m_eff
        rho = mu_aff / torch.clamp(mu, min=min_slack)
        sigma = torch.clamp(rho, 0.0, 1.0) ** cfg.sigma_pow

        # corrector with Mehrotra's second-order term
        rc = -(s * z + ds_a * dz_a - (sigma * mu)[..., None])
        dx, dy, dz, ds = newton(rc)

        alpha = _steplen(s, ds, z, dz, cfg.frac_to_boundary, imask)
        alpha = torch.where(done, torch.zeros_like(alpha), alpha)[..., None]
        x = x + alpha * dx
        y = y + alpha * dy
        z = torch.clamp(z + alpha * dz, min=min_slack)
        s = torch.clamp(s + alpha * ds, min=min_slack)

    rx, ry, rz = residuals(x, y, z, s)
    mu = (s * z * imask).sum(dim=-1) / m_eff
    res = res_norm(rx, ry, rz)
    conv = done | ((res < cfg.reltol) & (mu < cfg.abstol))

    # NaN quarantine: a blown-up lane comes back finite (zeros) and flagged
    lane_ok = (torch.isfinite(x).all(dim=-1) & torch.isfinite(y).all(dim=-1)
               & torch.isfinite(z).all(dim=-1))

    def sanitize(v):
        return torch.where(lane_ok[..., None], torch.nan_to_num(v),
                           torch.zeros_like(v))

    inf = float("inf")
    return QPSolution(x=sanitize(x), y=sanitize(y), z=sanitize(z),
                      s=sanitize(s), converged=conv & lane_ok, iters=it_conv,
                      gap=torch.nan_to_num(mu, nan=inf),
                      res_norm=torch.nan_to_num(res, nan=inf))


def make_qp(P, q, G, h, A=None, b=None, eq_mask=None,
            ineq_mask=None) -> QPData:
    """Convenience constructor filling default masks / an empty equality
    block."""
    P, q, G, h = (torch.as_tensor(v) for v in (P, q, G, h))
    batch, n = q.shape[:-1], q.shape[-1]
    opts = dict(dtype=P.dtype, device=P.device)
    if A is None:
        A = torch.zeros(batch + (1, n), **opts)
        b = torch.zeros(batch + (1,), **opts)
        eq_mask = torch.zeros(batch + (1,), **opts)
    else:
        A, b = torch.as_tensor(A), torch.as_tensor(b)
        if eq_mask is None:
            eq_mask = torch.ones(A.shape[:-1], **opts)
    if ineq_mask is None:
        ineq_mask = torch.ones(h.shape, **opts)
    return QPData(P=P, q=q, A=A, b=b, G=G, h=h,
                  eq_mask=torch.as_tensor(eq_mask),
                  ineq_mask=torch.as_tensor(ineq_mask))
