"""Work of the resident interior-point kernel (csrc/resident_ipm.cu), a
copy of chip_smoke.py's `knot_flops` and of its phase 6 bound.

One iteration of a lane is one Riccati factorization and two vector
passes (predictor and corrector) at every knot, and one rollout with its
residuals; a lane leaves the loop once converged, so it runs `iters` full
iterations and iters + 2 rollout sweeps (one fewer where it never
converged).  The operations are those of the iterations the lanes ran on
these inputs, not of the 15 they could run.  Bytes count each input once
(A, B, q, the stance mask, h per knot; x0) and each output once (u, x, z,
s per knot; the lane's status).
"""

import numpy as np

# the kernel's name, as portbench/trace.py's `seconds_of` matches it (the
# bf16 instance's too; not the WBC's resident_ipm_qp_kernel)
KERNEL = "resident_ipm_kernel"


def knot_flops(nx: int, nu: int, m: int) -> tuple[int, int, int]:
    """float32 operations (a multiply-add counts 2) of one knot of each
    Riccati pass: (rollout and residuals, factorization, one vector
    pass)."""
    rollout = 2 * (nx * nx + nx * nu              # x_{k+1} = A x + B u
                   + 2 * nx * nx                  # Q x, A' lam
                   + nu * nu + nx * nu + m * nu   # rx = R u + B' lam + G' z
                   + m * nu)                      # gu = G u
    factor = 2 * (nu * nx * nx + nx ** 3          # B'P, A'P
                  + nu * (nu + 1) // 2 * (m + nx)  # M, lower triangle
                  + nu * nx * nx                  # B'PA
                  + nu ** 3 // 6                  # Cholesky
                  + nx * nu * nu                  # K: two substitutions
                  + nx * nx * (nx + nu))          # P update
    vector = 2 * (m * nu + nx * nu + nu * nu      # g, kff (backward)
                  + nx * nx + nu * nx             # sv
                  + nu * nx + m * nu              # du, gdu (forward)
                  + nx * nx + nx * nu)            # dx
    return rollout, factor, vector


def plan_work(H: int, iters, converged, nx: int = 13, nu: int = 12,
              m: int = 24) -> tuple[float, float]:
    """(bytes, operations) of one plan of B lanes whose iteration counts
    and convergence flags are `iters`, `converged` (B,)."""
    its = np.asarray(iters, np.float64)
    sweeps = its + 1.0 + np.asarray(converged, np.float64)
    f_roll, f_fac, f_vec = knot_flops(nx, nu, m)
    flops = H * float((its * (f_fac + 2 * f_vec) + sweeps * f_roll).sum())
    B = its.shape[0]
    nbytes = 4 * B * (H * (nx * nx + nx * nu + nx + 2 * m)   # A, B, q, mask, h
                      + nx                                   # x0
                      + H * (nu + nx + 2 * m) + 4)           # u, x, z, s, stat
    return float(nbytes), flops
