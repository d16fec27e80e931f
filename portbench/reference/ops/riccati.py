"""Structure-exploiting interior-point solver for the horizon MPC QP.

Port of apf_quadruped_tpu/ops/riccati.py (`solve_stage_qp`, the lax.scan
backend).  It solves

    min   sum_k 1/2 x_{k+1}' Q x_{k+1} + q_k' x_{k+1} + 1/2 u_k' R u_k
    s.t.  x_{k+1} = A_k x_k + B_k u_k          (x_0 given)
          G u_k <= h          per knot, masked by the stance schedule
          [Cx x_{k+1} <= cx_k]   optional state rows
          [|B_k[6:12] u_k + A_k[6:12,12]| <= acc_rhs]   optional accel rows

by a fixed number of Mehrotra predictor-corrector iterations, each with one
Riccati factorization (12x12 Cholesky per knot) and two affine-LQR vector
passes, with per-lane convergence masks and NaN quarantine.

This is plain PyTorch: Python loops over the horizon, batched small matrix
ops over the scenario batch.  It is the port's CPU path (backend
"riccati"), and the plain version that tests/test_torch_riccati.py and
chip_smoke.py hold the CUDA kernel (ops/cuda_riccati.py) against.
SolverConfig.stage_bf16 does not reach it: like the JAX scan, it solves
with A and B as given (`round_stage_bf16` is the option's plain form for
the kernel backends).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .._device import constant
from .._precision import highest_precision
from ..config import SolverConfig


class StageQP(NamedTuple):
    """Stage-wise MPC QP data (leading batch dims allowed on everything).

    A: (.., H, NX, NX), B: (.., H, NX, NU)
    Q: (NX, NX) state cost (applied to x_{k+1}), qlin: (.., H, NX)
    R: (NU, NU) input cost
    G: (M, NU) per-knot inequality block (constant), h: (M,)
    mask: (.., H, M) row masks (stance schedule)
    x0: (.., NX)
    Cx: (MC, NX), cx: (.., H, MC), mask_x: (.., H, MC) — optional state
    rows Cx x_{k+1} <= cx (all three None = input rows only).
    acc_rhs: (6,) — optional accel rows |(x_{k+1} - x_k)[6:12]| <= acc_rhs
    in the SRB layout, derived from (A, B); solutions then carry z/s as
    (.., H, M + 12) with the accel rows last.
    """

    A: torch.Tensor
    B: torch.Tensor
    Q: torch.Tensor
    qlin: torch.Tensor
    R: torch.Tensor
    G: torch.Tensor
    h: torch.Tensor
    mask: torch.Tensor
    x0: torch.Tensor
    Cx: torch.Tensor | None = None
    cx: torch.Tensor | None = None
    mask_x: torch.Tensor | None = None
    acc_rhs: torch.Tensor | None = None


class StageSolution(NamedTuple):
    u: torch.Tensor          # (.., H, NU)
    x: torch.Tensor          # (.., H, NX) predicted states (after step k)
    z: torch.Tensor          # (.., H, M)
    s: torch.Tensor          # (.., H, M)
    converged: torch.Tensor  # (..,) bool
    iters: torch.Tensor      # (..,) int32
    gap: torch.Tensor        # (..,)
    res_norm: torch.Tensor   # (..,)
    zx: torch.Tensor | None = None   # (.., H, MC) state-row duals
    sx: torch.Tensor | None = None   # (.., H, MC) state-row slacks


class WarmStart(NamedTuple):
    """Previous-solve warm start: u (.., H, NU), z/s (.., H, M) and a
    per-lane `valid` flag (False lanes take the cold init).  z/s are
    floored to cfg.warm_floor."""

    u: torch.Tensor
    z: torch.Tensor
    s: torch.Tensor
    valid: torch.Tensor


def round_stage_bf16(qp: StageQP) -> StageQP:
    """qp with A and B rounded to bfloat16 (to nearest, ties to even) and
    widened back to their dtype: the data the resident and fused backends
    compute on under SolverConfig.stage_bf16, in plain form (their CPU
    routes, the plain versions of their bf16 kernels).  The scan ignores
    the option and never calls this."""
    return qp._replace(A=qp.A.to(torch.bfloat16).to(qp.A.dtype),
                       B=qp.B.to(torch.bfloat16).to(qp.B.dtype))


def _mv(a, v):
    return torch.einsum("...ij,...j->...i", a, v)


def _mtv(a, v):
    return torch.einsum("...ji,...j->...i", a, v)


def spd_factor(M):
    """Cholesky factor; NaN where M is not SPD (as jnp.linalg.cholesky
    returns it — the lane quarantine relies on the NaN)."""
    L, info = torch.linalg.cholesky_ex(M)
    return torch.where((info == 0)[..., None, None], L,
                       torch.full_like(L, float("nan")))


def spd_solve(L, r):
    """M^-1 r from the Cholesky factor L; r: (.., n) or (.., n, k)."""
    vec = r.dim() == L.dim() - 1
    if vec:
        r = r[..., None]
    w = torch.linalg.solve_triangular(L, r, upper=False)
    out = torch.linalg.solve_triangular(L.transpose(-1, -2), w, upper=True)
    return out[..., 0] if vec else out


def _spd_solve_factory(cfg: SolverConfig):
    """(factor, solve): factor(M) -> F, solve(F, r) -> M^-1 r for r (.., n)
    or (.., n, k).

    Default: one Cholesky factor per knot (spd_factor), two triangular
    solves per right-hand side.  cfg.use_pallas: F is M itself, and every
    solve refactors it inside the one-pass ops.chol.chol_solve (the CUDA
    kernel on the card, its plain version on the CPU) — at n = 12 the
    refactor is ~300 flops a matrix, cheaper than the launches it saves.
    """
    if cfg.use_pallas:
        from .chol import chol_solve
        return (lambda M: M), chol_solve
    return spd_factor, spd_solve


def solve_stage_qp(qp: StageQP, cfg: SolverConfig = SolverConfig(),
                   warm: WarmStart | None = None,
                   stop_at: torch.Tensor | None = None) -> StageSolution:
    """stop_at: (..,) iteration counts; each lane then stops after that
    many iterations instead of at the tolerances."""
    with highest_precision():
        return _solve_impl(qp, cfg, warm, stop_at)


def _solve_impl(qp: StageQP, cfg: SolverConfig,
                warm: WarmStart | None,
                stop_at: torch.Tensor | None = None) -> StageSolution:
    dt, dev = qp.x0.dtype, qp.x0.device
    batch = qp.x0.shape[:-1]
    Hh = qp.A.shape[-3]
    NX = qp.A.shape[-1]
    NU = qp.B.shape[-1]
    M = qp.h.shape[-1]

    def const(v):
        return constant(v, dt, dev)

    mask = qp.mask.to(dt)                                   # (.., H, M)
    G = qp.G.to(dt)
    hvec = torch.broadcast_to(qp.h.to(dt), batch + (Hh, M))
    hvec = torch.where(mask > 0, hvec, torch.ones_like(hvec))
    Gm = mask[..., None] * G                                # (.., H, M, NU)
    if qp.acc_rhs is not None:
        # accel rows: +-B[6:12,:] u <= acc_rhs -+ A[6:12,12] per knot
        SB = qp.B[..., 6:12, :]
        off = qp.A[..., 6:12, 12]
        rhs6 = torch.broadcast_to(qp.acc_rhs.to(dt), batch + (Hh, 6))
        Gm = torch.cat([Gm, SB, -SB], dim=-2)
        hvec = torch.cat([hvec, rhs6 - off, rhs6 + off], dim=-1)
        mask = torch.cat([mask, torch.ones(batch + (Hh, 12), dtype=dt,
                                           device=dev)], dim=-1)
        M = M + 12

    has_x = qp.Cx is not None
    m_eff = mask.sum(dim=(-1, -2))
    if has_x:
        Cx = qp.Cx.to(dt)
        MC = Cx.shape[0]
        mask_x = torch.broadcast_to(qp.mask_x.to(dt), batch + (Hh, MC))
        cxv = torch.broadcast_to(qp.cx.to(dt), batch + (Hh, MC))
        cxv = torch.where(mask_x > 0, cxv, torch.ones_like(cxv))
        Cm = mask_x[..., None] * Cx                         # (.., H, MC, NX)
        m_eff = m_eff + mask_x.sum(dim=(-1, -2))
    m_eff = torch.clamp(m_eff, min=1.0)

    reg = const(cfg.static_reg)
    frac = const(cfg.frac_to_boundary)
    min_slack, w_hi = cfg.min_slack, cfg.w_clip
    eye_u = torch.eye(NU, dtype=dt, device=dev)
    Q = qp.Q.to(dt)
    R = qp.R.to(dt)

    def h_first(v):
        return torch.movedim(v, len(batch), 0)

    def h_last(v):
        return torch.movedim(v, 0, len(batch))

    A_t = h_first(qp.A.to(dt))
    B_t = h_first(qp.B.to(dt))
    q_t = h_first(qp.qlin.to(dt))
    G_t = h_first(Gm)
    h_t = h_first(hvec)
    mask_t = h_first(mask)
    if has_x:
        C_t = h_first(Cm)
        cx_t = h_first(cxv)
        maskx_t = h_first(mask_x)

    def rollout(u_t):
        """x_{k+1} sequence (H, .., NX) from controls (H, .., NU)."""
        x, xs = qp.x0.to(dt), []
        for k in range(Hh):
            x = _mv(A_t[k], x) + _mv(B_t[k], u_t[k])
            xs.append(x)
        return torch.stack(xs)

    def residuals(u_t, z_t, s_t, zx_t, sx_t, x_t):
        """rx: stationarity in u via the costates of the rollout cost;
        rz = G u + s - h; rzx = Cm x_{k+1} + sx - cx."""
        lam = torch.zeros(batch + (NX,), dtype=dt, device=dev)
        lam_t = [None] * Hh
        for k in reversed(range(Hh)):
            lam_k = _mv(Q, x_t[k]) + q_t[k] + lam
            if has_x:
                lam_k = lam_k + _mtv(C_t[k], zx_t[k])
            lam_t[k] = lam_k
            lam = _mtv(A_t[k], lam_k)
        lam_t = torch.stack(lam_t)
        rx = _mv(R, u_t) + _mtv(B_t, lam_t) + _mtv(G_t, z_t)
        rz = _mv(G_t, u_t) + s_t - h_t
        rzx = _mv(C_t, x_t) + sx_t - cx_t if has_x else None
        return rx, rz, rzx

    factor, solve = _spd_solve_factory(cfg)

    def riccati_factor(W_t, Wx_t):
        """Backward matrix pass; the carry Pbar_{k+1} = Q + P_{k+1} is the
        cost-to-go Hessian at x_{k+1} including that stage's state cost.
        Returns per-knot factors L_k (M_k itself under use_pallas) and
        gains K_k."""
        Pbar = torch.broadcast_to(Q, batch + (NX, NX))
        L_t, K_t = [None] * Hh, [None] * Hh
        for k in reversed(range(Hh)):
            Ak, Bk, Gk = A_t[k], B_t[k], G_t[k]
            Pb = Pbar
            if has_x:
                Pb = Pb + C_t[k].transpose(-1, -2) @ (Wx_t[k][..., None]
                                                      * C_t[k])
            Rk = R + reg * eye_u + Gk.transpose(-1, -2) @ (W_t[k][..., None]
                                                           * Gk)
            BtP = Bk.transpose(-1, -2) @ Pb                    # (.., NU, NX)
            Lk = factor(Rk + BtP @ Bk)
            BtPA = BtP @ Ak
            K = solve(Lk, BtPA)                                # (.., NU, NX)
            AtP = Ak.transpose(-1, -2) @ Pb
            Pn = Q + AtP @ Ak - K.transpose(-1, -2) @ BtPA
            Pbar = 0.5 * (Pn + Pn.transpose(-1, -2))
            L_t[k], K_t[k] = Lk, K
        return L_t, K_t

    def riccati_solve(L_t, K_t, rx_t, rz_over_t, vmx_t):
        """Affine-LQR pass against the stored factorizations: solve
        Hess(U) dU = -(rx + rz_over), the state rows' linear term vmx
        entering the value gradient at x_{k+1}.  Returns (du_t, dx1_t)."""
        rhs_t = -(rx_t + rz_over_t)
        sv = torch.zeros(batch + (NX,), dtype=dt, device=dev)
        kff_t = [None] * Hh
        for k in reversed(range(Hh)):
            if has_x:
                sv = sv + _mtv(C_t[k], vmx_t[k])
            g_u = -rhs_t[k] + _mtv(B_t[k], sv)
            kff_t[k] = solve(L_t[k], g_u)
            sv = _mtv(A_t[k], sv) - _mtv(K_t[k], g_u)
        dx = torch.zeros(batch + (NX,), dtype=dt, device=dev)
        du_t, dx1_t = [], []
        for k in range(Hh):
            du = -_mv(K_t[k], dx) - kff_t[k]
            dx = _mv(A_t[k], dx) + _mv(B_t[k], du)
            du_t.append(du)
            dx1_t.append(dx)
        return torch.stack(du_t), torch.stack(dx1_t)

    # --- initial point ---------------------------------------------------
    u_t = torch.zeros((Hh,) + batch + (NU,), dtype=dt, device=dev)
    x_t = rollout(u_t)
    r0 = -h_t                                     # G u - h at u = 0
    shift = torch.clamp(r0.amax(dim=(0, -1), keepdim=True), min=0.0) + 1.0
    s_t = -r0 + shift
    z_t = torch.clamp(r0, min=0.0) + 1.0
    zx_t = sx_t = None
    if has_x:
        r0x = _mv(C_t, x_t) - cx_t
        shiftx = torch.clamp(r0x.amax(dim=(0, -1), keepdim=True),
                             min=0.0) + 1.0
        sx_t = -r0x + shiftx
        zx_t = torch.clamp(r0x, min=0.0) + 1.0
    if warm is not None:
        floor = const(cfg.warm_floor)
        v = warm.valid.to(torch.bool)[..., None]          # (.., 1)
        u_t = torch.where(v, h_first(warm.u.to(dt)), u_t)
        z_t = torch.where(v, torch.maximum(h_first(warm.z.to(dt)), floor),
                          z_t)
        s_t = torch.where(v, torch.maximum(h_first(warm.s.to(dt)), floor),
                          s_t)

    qnorm = 1.0 + torch.sqrt((q_t * q_t).sum(dim=(0, -1)))
    hn2 = (h_t * h_t).sum(dim=(0, -1))
    if has_x:
        hn2 = hn2 + (cx_t * cx_t).sum(dim=(0, -1))
    hnorm = 1.0 + torch.sqrt(hn2)

    def measure(u_t, z_t, s_t, zx_t, sx_t):
        """Rollout, residuals, duality measure mu and residual norm res."""
        x_t = rollout(u_t)
        rx_t, rz_t, rzx_t = residuals(u_t, z_t, s_t, zx_t, sx_t, x_t)
        sz = (s_t * z_t * mask_t).sum(dim=(0, -1))
        rz2 = ((rz_t * mask_t) ** 2).sum(dim=(0, -1))
        if has_x:
            sz = sz + (sx_t * zx_t * maskx_t).sum(dim=(0, -1))
            rz2 = rz2 + ((rzx_t * maskx_t) ** 2).sum(dim=(0, -1))
        mu = sz / m_eff
        res = torch.maximum(torch.sqrt((rx_t * rx_t).sum(dim=(0, -1)))
                            / qnorm, torch.sqrt(rz2) / hnorm)
        return x_t, rx_t, rz_t, rzx_t, mu, res

    def ratio(v, dv, mk):
        neg = (dv < 0) & (mk > 0)
        r = torch.where(neg, -v / torch.where(neg, dv, -torch.ones_like(dv)),
                        torch.full_like(v, float("inf")))
        return r.amin(dim=(0, -1))

    def steplen(s, ds, z, dz, sx, dsx, zx, dzx, f):
        a = torch.minimum(ratio(s, ds, mask_t), ratio(z, dz, mask_t))
        if has_x:
            a = torch.minimum(a, torch.minimum(ratio(sx, dsx, maskx_t),
                                               ratio(zx, dzx, maskx_t)))
        return torch.clamp(f * a, max=1.0)

    done = torch.zeros(batch, dtype=torch.bool, device=dev)
    it_conv = torch.full(batch, cfg.iters, dtype=torch.int32, device=dev)
    for it in range(cfg.iters):
        # a lane that is done takes zero steps from then on, so once every
        # lane is done the remaining iterations change nothing, unless a
        # step is not finite (0 * inf is NaN).  The CPU leaves the loop
        # then; the card runs every iteration, as the JAX scan does, with
        # no host read, so that a plan can be captured as a CUDA graph
        if dev.type == "cpu" and bool(done.all()):
            break
        x_t, rx_t, rz_t, rzx_t, mu, res = measure(u_t, z_t, s_t, zx_t, sx_t)
        now = ((res < cfg.reltol) & (mu < cfg.abstol) if stop_at is None
               else stop_at <= it)
        it_conv = torch.where(now & ~done, it, it_conv)
        done = done | now

        s_safe = torch.clamp(s_t, min=min_slack)
        W_t = torch.clamp(torch.clamp(z_t, min=min_slack) / s_safe, 0.0, w_hi)
        Wx_t = sx_safe = None
        if has_x:
            sx_safe = torch.clamp(sx_t, min=min_slack)
            Wx_t = torch.clamp(torch.clamp(zx_t, min=min_slack) / sx_safe,
                               0.0, w_hi)
        L_t, K_t = riccati_factor(W_t, Wx_t)

        def newton(rc, rcx):
            rz_over = _mtv(G_t, W_t * rz_t + rc / s_safe)
            vmx = (maskx_t * (Wx_t * rzx_t + rcx / sx_safe)) if has_x \
                else None
            du_t, dx1_t = riccati_solve(L_t, K_t, rx_t, rz_over, vmx)
            ds = -rz_t - _mv(G_t, du_t)
            dz = (rc - z_t * ds) / s_safe
            dsx = dzx = None
            if has_x:
                dsx = -rzx_t - _mv(C_t, dx1_t)
                dzx = (rcx - zx_t * dsx) / sx_safe
            return du_t, dz, ds, dzx, dsx

        du_a, dz_a, ds_a, dzx_a, dsx_a = newton(
            -s_t * z_t, -sx_t * zx_t if has_x else None)
        a_a = steplen(s_t, ds_a, z_t, dz_a, sx_t, dsx_a, zx_t, dzx_a,
                      const(1.0))[..., None]
        sz_aff = ((s_t + a_a * ds_a) * (z_t + a_a * dz_a)
                  * mask_t).sum(dim=(0, -1))
        if has_x:
            sz_aff = sz_aff + ((sx_t + a_a * dsx_a) * (zx_t + a_a * dzx_a)
                               * maskx_t).sum(dim=(0, -1))
        mu_aff = sz_aff / m_eff
        sigma = torch.clamp(mu_aff / torch.clamp(mu, min=min_slack), 0.0,
                            1.0) ** cfg.sigma_pow
        sig_mu = (sigma * mu)[..., None]
        rc = -(s_t * z_t + ds_a * dz_a - sig_mu)
        rcx = -(sx_t * zx_t + dsx_a * dzx_a - sig_mu) if has_x else None
        du_t, dz, ds, dzx, dsx = newton(rc, rcx)

        a = steplen(s_t, ds, z_t, dz, sx_t, dsx, zx_t, dzx, frac)
        a = torch.where(done, torch.zeros_like(a), a)[..., None]
        u_t = u_t + a * du_t
        z_t = torch.clamp(z_t + a * dz, min=min_slack)
        s_t = torch.clamp(s_t + a * ds, min=min_slack)
        if has_x:
            zx_t = torch.clamp(zx_t + a * dzx, min=min_slack)
            sx_t = torch.clamp(sx_t + a * dsx, min=min_slack)

    x_t, _, _, _, mu, res = measure(u_t, z_t, s_t, zx_t, sx_t)
    conv = done | ((res < cfg.reltol) & (mu < cfg.abstol))
    return finalize(h_last(u_t), h_last(x_t), h_last(z_t), h_last(s_t),
                    conv, it_conv, mu, res,
                    h_last(zx_t) if has_x else None,
                    h_last(sx_t) if has_x else None)


def finalize(u, x, z, s, conv, iters, mu, res, zx=None, sx=None):
    """NaN quarantine: a lane with any non-finite u or x comes back zeroed
    and unconverged; gap/res_norm map NaN to inf."""
    lane_ok = (torch.isfinite(u).all(dim=-1).all(dim=-1)
               & torch.isfinite(x).all(dim=-1).all(dim=-1))
    ok = lane_ok[..., None, None]

    def fix(v):
        return torch.where(ok, torch.nan_to_num(v), torch.zeros_like(v))

    inf = float("inf")
    return StageSolution(
        u=fix(u), x=fix(x), z=fix(z), s=fix(s),
        converged=conv & lane_ok, iters=iters.to(torch.int32),
        gap=torch.nan_to_num(mu, nan=inf),
        res_norm=torch.nan_to_num(res, nan=inf),
        zx=fix(zx) if zx is not None else None,
        sx=fix(sx) if sx is not None else None)
