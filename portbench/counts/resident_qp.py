"""Work of the resident QP kernel (csrc/resident_qp.cu), the WBC's
interior-point solve in one launch, one warp a QP: a copy of
chip_smoke.py's `qp_work`.

Every lane runs all of the solver's iterations (the kernel has no early
exit: a converged lane keeps stepping), so the work is the same for every
input of a shape.  A multiply-add counts 2; each input is read once and
each output written once.
"""

from .peaks import least_seconds

# the kernel's name, as portbench/trace.py's `seconds_of` matches it
KERNEL = "resident_ipm_qp_kernel"


def qp_work(B, n=30, p=30, m=68, iters=15, refine=1):
    """(bytes, float32 operations) of one solve of B QPs of n variables, p
    equality and m inequality rows (the WBC's: 30, 30, 68), every lane
    running all `iters` iterations with `refine` refinement steps.  A
    factorization pass: the Gram G'WG's lower triangle and W G, H's
    factor, V = L^-1 A' (p forward substitutions), V'V's lower triangle
    and S_eq's factor; a KKT solve: two half substitutions with L and V'u,
    S_eq's two, V dy; each refinement H dx (P, G, W, G'), A'dy, A dx; a
    Newton step: the right-hand side G'(w rz + rc / s), the KKT solve,
    ds = -rz - G dx and dz; the residuals: P x, A'y, G'z, A x, G x and the
    sums."""
    tri = lambda k: k * (k + 1) // 2                     # noqa: E731
    chol = lambda k: (k ** 3 - k) / 3 + k * (k - 1) / 2 + 2 * k  # noqa
    factor = (2 * tri(n) * m + m * n + chol(n) + p * n * n
              + 2 * tri(p) * n + chol(p))
    once = 2 * n * n + 4 * n * p + 2 * p * p
    kkt = (1 + refine) * once + refine * (2 * (2 * m * n) + m + 2 * n * n
                                          + 2 * (2 * n * p) + n + p)
    newton = 2 * m * n + 3 * m + kkt + 2 * m * n + 4 * m
    resid = 2 * n * n + 4 * n * p + 4 * m * n + 6 * m + 2 * (n + p)
    step = 10 * m + 2 * (n + p)           # step lengths, mu_aff, the update
    flops = ((iters + 1) * factor + iters * (2 * newton + step)
             + (iters + 1) * resid + kkt + 2 * m * n)
    nbytes = 4 * (n * n + n + p * n + 2 * p + m * n + 2 * m   # P .. masks
                  + n + p + 2 * m + 3) + 1                    # x .. res
    return float(B * nbytes), float(B * flops)


def roofline_pct(launches: int, seconds: float, B: int, solver):
    """The kernel's share of its roofline, in %: the least time of
    `launches` solves of B WBC QPs under `solver` (a SolverConfig: its
    iterations and refinement steps) over their device time `seconds`;
    None where no launch was recorded."""
    if not launches:
        return None
    need = least_seconds(*qp_work(B, iters=solver.iters,
                                  refine=solver.refine_steps))[0]
    return 100.0 * launches * need / seconds
