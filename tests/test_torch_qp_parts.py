"""The port's SPD factor/solve pair and dense QP solver vs the JAX
package, on the CPU.

The plain versions beside the CUDA kernels (ops/chol.py) are held to the
TPU kernels they port, chol_factor_blocked / chol_sub_blocked run in
interpret mode as tests/test_pallas_chol.py runs them, at float32
rounding (1e-5 of the largest entry).  solve_qp is held to the JAX
package's in float64: convergence flags and iteration counts exactly, the
solution within 1e-8 absolute and 1e-9 relative (an infeasible lane's
duals grow large; the interior point amplifies rounding by the KKT
condition number).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_parity_inputs import T, close
from apf_quadruped_tpu.config import SolverConfig as JSolverConfig
from apf_quadruped_tpu.ops import pallas_chol, qpsolve as jqp
from apf_quadruped_tpu_torch import convert
from apf_quadruped_tpu_torch.config import SolverConfig
from apf_quadruped_tpu_torch.ops import chol, qpsolve as tqp

torch.set_num_threads(1)


# ---------------------------------------------------------------------------
# the SPD pair, the dense QP solver, the WBC, the physics
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,k", [(9, 1), (9, 4), (18, 1), (18, 30)])
def test_plain_spd_pair_matches_pallas_kernels(rng, n, k):
    """The plain versions beside the CUDA kernels vs the TPU kernels
    (interpret mode) they port: L, dinv and X at float32 rounding."""
    A = rng.normal(size=(5, n, n))
    H = (A @ A.transpose(0, 2, 1) + n * np.eye(n)).astype(np.float32)
    rhs = rng.normal(size=(5, n, k)).astype(np.float32)
    L_j, d_j = pallas_chol.chol_factor_blocked(jnp.asarray(H),
                                               interpret=True)
    X_j = pallas_chol.chol_sub_blocked(L_j, d_j, jnp.asarray(rhs),
                                       interpret=True)
    L_t, d_t = chol.spd_factor(T(H))
    X_t = chol.spd_solve((L_t, d_t), T(rhs))
    close(L_t, L_j, 1e-5 * np.abs(np.asarray(L_j)).max())
    close(d_t, d_j, 1e-5 * np.abs(np.asarray(d_j)).max())
    close(X_t, X_j, 1e-5 * np.abs(np.asarray(X_j)).max())
    assert torch.equal(torch.triu(L_t, 1), torch.zeros_like(L_t))
    # vector right-hand sides, and a lane that is not positive definite
    assert torch.equal(chol.spd_solve((L_t, d_t), T(rhs[..., 0])),
                       chol.spd_solve((L_t, d_t), T(rhs[..., :1]))[..., 0])
    H[1, 0, 0] = -1.0
    L_bad, d_bad = chol.spd_factor(T(H))
    assert bool(L_bad[1].isnan().all() & d_bad[1].isnan().all())
    assert bool(L_bad[[0, 2, 3, 4]].isfinite().all())


@pytest.mark.parametrize("n,width", [(1, 12), (5, 12), (11, 12), (1, 18),
                                     (17, 18), (19, 30), (29, 30)])
def test_identity_padding_is_exact(rng, n, width):
    """The CUDA kernels run an n x n matrix at a compile-time width >= n
    (12 for the factor-and-solve only, 18, 30), padded with an identity
    block (csrc/spd_chol.cu): the factor of
    diag(H, I) is diag(L_H, I), and the padded solve with zero rows below
    the right-hand side gives the unpadded solution over zeros."""
    A = rng.normal(size=(3, n, n))
    H = A @ A.transpose(0, 2, 1) + n * np.eye(n)
    rhs = rng.normal(size=(3, n, 2))
    Hp = np.tile(np.eye(width), (3, 1, 1))
    Hp[:, :n, :n] = H
    L, d = chol.plain_factor(T(H))
    Lp, dp = chol.plain_factor(T(Hp))
    close(Lp[:, :n, :n], L, 1e-12)
    close(dp[:, :n], d, 1e-12)
    assert torch.equal(Lp[:, n:, :], T(Hp)[:, n:, :])
    assert torch.equal(dp[:, n:], torch.ones(3, width - n, dtype=dp.dtype))
    rp = np.zeros((3, width, 2))
    rp[:, :n] = rhs
    Xp = chol.plain_solve(Lp, dp, T(rp))
    close(Xp[:, :n], chol.plain_solve(L, d, T(rhs)), 1e-12)
    assert torch.equal(Xp[:, n:], torch.zeros(3, width - n, 2,
                                              dtype=Xp.dtype))


def _random_qp(rng, n, m, p, batch):
    M = rng.normal(size=batch + (n, n))
    P = np.einsum("...ij,...kj->...ik", M, M) / n + 0.5 * np.eye(n)
    q = rng.normal(size=batch + (n,))
    G = rng.normal(size=batch + (m, n))
    x0 = rng.normal(size=batch + (n,)) * 0.1
    h = np.einsum("...mn,...n->...m", G, x0) + rng.uniform(0.1, 1.0,
                                                           batch + (m,))
    A = rng.normal(size=batch + (p, n))
    b = np.einsum("...pn,...n->...p", A, x0)
    return P, q, G, h, A, b


@pytest.mark.parametrize("refine", [0, 1, 2])
def test_solve_qp_matches_jax(rng, refine):
    """Masked rows, an infeasible lane (quarantined), refinement steps."""
    P, q, G, h, A, b = _random_qp(rng, 12, 20, 5, (4,))
    ineq_mask = (rng.uniform(size=(4, 20)) < 0.8).astype(float)
    eq_mask = np.ones((4, 5))
    eq_mask[1, 3:] = 0.0
    G[3, 0], G[3, 1] = np.eye(12)[0], -np.eye(12)[0]   # x0 <= -1, -x0 <= -1
    h[3, 0:2] = -1.0
    ineq_mask[3, 0:2] = 1.0
    data = dict(P=P, q=q, A=A, b=b, G=G, h=h, eq_mask=eq_mask,
                ineq_mask=ineq_mask)
    cfg = dict(iters=25, reltol=1e-7, abstol=1e-8, static_reg=1e-8,
               eq_reg=1e-8, w_clip=1e8, refine_steps=refine)
    sol_j = jqp.solve_qp(jqp.QPData(**{k: jnp.asarray(v)
                                       for k, v in data.items()}),
                         JSolverConfig(**cfg))
    sol_t = tqp.solve_qp(convert.qp_data(data), SolverConfig(**cfg))
    close(sol_t.converged, sol_j.converged, 0)
    close(sol_t.iters, sol_j.iters, 0)
    assert not bool(sol_t.converged[3])
    for f in ("x", "y", "z", "s"):
        # the infeasible lane's duals grow large: relative there
        close(getattr(sol_t, f), getattr(sol_j, f), 1e-8, rtol=1e-9)
        assert bool(getattr(sol_t, f).isfinite().all())
    close(sol_t.gap, sol_j.gap, 1e-8, rtol=1e-9)


def test_make_qp_matches_jax(rng):
    P, q, G, h, _, _ = _random_qp(rng, 6, 8, 1, (2,))
    qp_j = jqp.make_qp(P, q, G, h)
    qp_t = tqp.make_qp(T(P), T(q), T(G), T(h))
    for a, b in zip(qp_t, qp_j):
        close(a, b, 0)
