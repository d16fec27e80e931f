"""SPD factor / solve of the dense QP solver, the physics and the scan IPM.

Port of the router in apf_quadruped_tpu/ops/pallas_chol.py (`spd_factor`,
`spd_solve`) and of its one-pass `chol_solve_blocked`.  The JAX package
writes single-scenario code and swaps the batch-on-lanes Pallas kernels in
under vmap; the port is batched explicitly, so the route is chosen by the
tensors' device and shape instead:

  * CUDA tensors with n <= KERNEL_MAX_N (64) launch the hand-written
    kernels (ops/cuda_chol.py, csrc/spd_chol.cu); another dtype than
    float32 or a failed build raises;
  * CUDA tensors with n > KERNEL_MAX_N take cholesky_ex and the triangular
    solves, as the JAX router sends such sizes (the condensed planner's
    n = 12H) to XLA's plain Cholesky.  A rule on shape, applied before any
    launch;
  * CPU tensors take the plain versions below (`plain_factor`,
    `plain_solve`, `plain_chol_solve`): cholesky_ex with a NaN fill where
    the matrix is not positive definite, as jnp.linalg.cholesky returns
    it, and two triangular solves.

`spd_factor(H)` returns the pair (L, dinv), dinv = 1 / diag(L),
`spd_solve((L, dinv), r)` takes r of shape (.., n) or (.., n, k), and
`chol_solve(M, r)` factors and solves in one call.
"""

from __future__ import annotations

import math

import torch

from . import cuda_chol
from .riccati import spd_factor as _cholesky, spd_solve as _tri_solve

KERNEL_MAX_N = 64   # the kernels' size limit (csrc/spd_chol.cu N_MAX)


def plain_factor(H: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    L = _cholesky(H)
    return L, 1.0 / torch.diagonal(L, dim1=-2, dim2=-1)


def plain_solve(L: torch.Tensor, dinv: torch.Tensor,
                r: torch.Tensor) -> torch.Tensor:
    del dinv
    return _tri_solve(L, r)


def plain_chol_solve(M: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """M^-1 r for SPD M; NaN where M is not positive definite."""
    return plain_solve(*plain_factor(M), r)


def _on_kernel(t: torch.Tensor) -> bool:
    """Whether `t`'s (.., n, n) matrices go to a kernel: CUDA and
    n <= KERNEL_MAX_N; False for the CPU; raises for another device."""
    kind = t.device.type
    if kind not in ("cpu", "cuda"):
        raise ValueError(f"spd_factor/spd_solve: unsupported device {t.device}")
    return kind == "cuda" and t.shape[-1] <= KERNEL_MAX_N


def spd_factor(H: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """H (.., n, n) SPD -> (L, dinv)."""
    if not _on_kernel(H):
        return plain_factor(H)
    if H.dim() == 3:
        return cuda_chol.chol_factor(H)
    batch, n = H.shape[:-2], H.shape[-1]
    L, dinv = cuda_chol.chol_factor(H.reshape((math.prod(batch), n, n)))
    return L.reshape(H.shape), dinv.reshape(batch + (n,))


def _batched(L: torch.Tensor, rk: torch.Tensor):
    """(batch, L as (nb, n, n), rk as (nb, n, k)) with broadcast batch
    dims."""
    n, k = L.shape[-1], rk.shape[-1]
    batch = torch.broadcast_shapes(L.shape[:-2], rk.shape[:-2])
    nb = math.prod(batch)
    return (batch, torch.broadcast_to(L, batch + (n, n)).reshape(nb, n, n),
            torch.broadcast_to(rk, batch + (n, k)).reshape(nb, n, k))


def spd_solve(F, r: torch.Tensor) -> torch.Tensor:
    """Solve against a stored spd_factor pair F = (L, dinv); r (.., n) or
    (.., n, k), batch dims broadcast against L's."""
    L, dinv = F
    if not _on_kernel(L):
        return plain_solve(L, dinv, r)
    vec = r.dim() == L.dim() - 1
    rk = r[..., None] if vec else r
    if L.dim() == rk.dim() == 3 and rk.shape[0] == L.shape[0]:
        X = cuda_chol.chol_sub(L, dinv, rk)
        return X[..., 0] if vec else X
    batch, Lb, rb = _batched(L, rk)
    n = L.shape[-1]
    nb = Lb.shape[0]
    X = cuda_chol.chol_sub(
        Lb, torch.broadcast_to(dinv, batch + (n,)).reshape(nb, n), rb)
    X = X.reshape(batch + X.shape[-2:])
    return X[..., 0] if vec else X


def chol_solve(M: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """M^-1 r for SPD M (.., n, n), r (.., n) or (.., n, k): the factor and
    the solve in one call, NaN on a matrix that is not positive definite.
    On CUDA with n <= KERNEL_MAX_N one launch of the kernel."""
    if not _on_kernel(M):
        return plain_chol_solve(M, r)
    vec = r.dim() == M.dim() - 1
    rk = r[..., None] if vec else r
    batch, Mb, rb = _batched(M, rk)
    X = cuda_chol.chol_solve(Mb, rb).reshape(batch + rk.shape[-2:])
    return X[..., 0] if vec else X
