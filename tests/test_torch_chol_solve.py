"""The one-pass SPD factor-and-solve of the port (ops/chol.py chol_solve,
the CUDA kernel's plain version on the CPU) against the JAX package's
TPU kernel, and the scan IPM's use_pallas option that routes through it.

  * plain_chol_solve against apf_quadruped_tpu/ops/pallas_chol.py::
    chol_solve_blocked (interpret mode) at the scan's n = 12 with k = 13
    (the gains) and k = 1 (the feed-forward), float32, atol 1e-5 relative
    to the largest entry (a few float32 roundings of 12-term sums on
    well-conditioned input).  The TPU kernel solves each column on its own
    after the same factorization, so its k = 13 answer is taken from one
    k = 1 call with the columns on the lanes (tracing the unrolled k = 13
    body in interpret mode takes over a minute);
  * a matrix that is not positive definite gives a NaN solution;
  * solve_stage_qp with use_pallas against the JAX package's
    (tests/test_riccati.py test_pallas_path_matches_default, atol 2e-4)
    and against the port's own default path.
The kernel itself runs on the card (tests/test_torch_cuda.py).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apf_quadruped_tpu.config import SolverConfig as JSolverConfig
from apf_quadruped_tpu.ops.pallas_chol import chol_solve_blocked
from apf_quadruped_tpu.ops.riccati import StageQP as JStageQP
from apf_quadruped_tpu.ops.riccati import solve_stage_qp as jsolve
from apf_quadruped_tpu_torch import convert, problems
from apf_quadruped_tpu_torch.config import SolverConfig
from apf_quadruped_tpu_torch.ops import chol, cuda_chol
from apf_quadruped_tpu_torch.ops import riccati as tr

torch.set_num_threads(1)

CFG = SolverConfig(iters=15, reltol=1e-4, abstol=1e-4, static_reg=1e-6,
                   w_clip=1e6)


def _spd(rng, B, n):
    A = rng.normal(size=(B, n, n))
    return (A @ A.transpose(0, 2, 1) + n * np.eye(n)).astype(np.float32)


@pytest.mark.parametrize("n,width", [(1, 12), (5, 12), (11, 12), (13, 18),
                                     (19, 30)])
@pytest.mark.parametrize("k", [1, 13])
def test_padded_chol_solve_is_exact(rng, n, width, k):
    """The factor-and-solve kernel runs n x n at a compile-time width >= n
    (csrc/spd_chol.cu: 12, 18 or 30), M padded with an identity block and
    the right-hand sides with zero rows: the padded solve, sliced back, is
    the unpadded one (float64, 1e-12), with exact zeros on the padded
    rows."""
    A = rng.normal(size=(3, n, n))
    M = A @ A.transpose(0, 2, 1) + n * np.eye(n)
    r = rng.normal(size=(3, n, k))
    Mp = np.tile(np.eye(width), (3, 1, 1))
    Mp[:, :n, :n] = M
    rp = np.zeros((3, width, k))
    rp[:, :n] = r
    X = chol.plain_chol_solve(torch.as_tensor(M), torch.as_tensor(r))
    Xp = chol.plain_chol_solve(torch.as_tensor(Mp), torch.as_tensor(rp))
    assert Xp.dtype == torch.float64
    torch.testing.assert_close(Xp[:, :n], X, rtol=0, atol=1e-12)
    assert torch.equal(Xp[:, n:], torch.zeros(3, width - n, k,
                                              dtype=torch.float64))


@pytest.mark.parametrize("k", [1, 13])
def test_plain_chol_solve_matches_tpu_kernel(rng, k):
    B = 65 // k                       # one 65-lane kernel call either way
    M = _spd(rng, B, 12)
    r = rng.normal(size=(B, 12, k)).astype(np.float32)
    lanes = np.repeat(M, k, axis=0)                    # (B k, 12, 12)
    cols = np.moveaxis(r, -1, 1).reshape(B * k, 12, 1)
    ref = np.asarray(chol_solve_blocked(jnp.asarray(lanes), jnp.asarray(cols),
                                        interpret=True))
    ref = np.moveaxis(ref.reshape(B, k, 12), 1, -1)
    out = chol.plain_chol_solve(torch.as_tensor(M), torch.as_tensor(r))
    assert out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), ref, rtol=0,
                               atol=1e-5 * np.abs(ref).max())


def test_chol_solve_shapes_and_cpu_route(rng):
    """Vector and matrix right-hand sides, several batch axes and a batch
    broadcast give the same answers; CPU tensors launch nothing."""
    M = torch.as_tensor(_spd(rng, 6, 12))
    r = torch.as_tensor(rng.normal(size=(6, 12, 3)).astype(np.float32))
    before = cuda_chol.chol_solve.launches
    X = chol.chol_solve(M, r)
    tol = dict(rtol=0, atol=1e-6 * float(X.abs().max()))
    np.testing.assert_allclose(chol.chol_solve(M, r[..., 0]).numpy(),
                               X[..., 0].numpy(), **tol)
    assert torch.equal(chol.chol_solve(M.reshape(2, 3, 12, 12),
                                       r.reshape(2, 3, 12, 3)).reshape(6, 12, 3),
                       X)
    np.testing.assert_allclose(chol.chol_solve(M[0], r).numpy(),
                               chol.plain_chol_solve(M[0].expand(6, 12, 12),
                                                     r).numpy(), **tol)
    assert cuda_chol.chol_solve.launches == before


def test_chol_solve_nan_lane(rng):
    M = _spd(rng, 4, 12)
    M[2, 5, 5] = -3.0
    X = chol.chol_solve(torch.as_tensor(M), torch.ones(4, 12, 13))
    assert bool(X[2].isnan().all())
    assert bool(X[[0, 1, 3]].isfinite().all())


def _stage(rng):
    return problems.random_stage_qp(rng, B=4, H=5, NX=6, NU=4, M=6)


def test_use_pallas_matches_jax(rng):
    d = _stage(rng)
    jcfg = JSolverConfig(iters=15, reltol=1e-4, abstol=1e-4, static_reg=1e-6,
                         w_clip=1e6, use_pallas=True)
    ref = jsolve(JStageQP(**{k: jnp.asarray(v) for k, v in d.items()}), jcfg)
    out = tr.solve_stage_qp(convert.stage_qp(d),
                            dataclasses.replace(CFG, use_pallas=True))
    np.testing.assert_allclose(out.u.numpy(), np.asarray(ref.u), rtol=0,
                               atol=2e-4)
    np.testing.assert_array_equal(out.converged.numpy(),
                                  np.asarray(ref.converged))


@pytest.mark.parametrize("mc,acc", [(0, False), (6, True)])
def test_use_pallas_matches_default_path(rng, mc, acc):
    """use_pallas changes how each 12x12 system is solved, not the answer
    (on the CPU both take cholesky_ex and the triangular solves)."""
    dims = dict(NX=13, NU=12, M=24) if acc else {}
    qp = convert.stage_qp(problems.random_stage_qp(rng, mc=mc, acc=acc,
                                                   **dims))
    a = tr.solve_stage_qp(qp, CFG)
    b = tr.solve_stage_qp(qp, dataclasses.replace(CFG, use_pallas=True))
    for f in ("u", "x", "z", "converged", "iters"):
        assert torch.equal(getattr(a, f), getattr(b, f)), f

