"""SPD factor / solve pair of the dense QP solver and the physics.

Port of the router in apf_quadruped_tpu/ops/pallas_chol.py (`spd_factor`,
`spd_solve`).  The JAX package writes single-scenario code and swaps the
batch-on-lanes Pallas kernels in under vmap; the port is batched
explicitly, so the route is chosen by the tensors' device instead:

  * CUDA tensors with n <= 64 launch the hand-written kernels
    (ops/cuda_chol.py, csrc/spd_chol.cu); n > 64, another dtype than
    float32 or a failed build raise;
  * CPU tensors take the plain versions below (`plain_factor`,
    `plain_solve`): cholesky_ex with a NaN fill where the matrix is not
    positive definite, as jnp.linalg.cholesky returns it, and two
    triangular solves.

`spd_factor(H)` returns the pair (L, dinv), dinv = 1 / diag(L), and
`spd_solve((L, dinv), r)` takes r of shape (.., n) or (.., n, k).
"""

from __future__ import annotations

import math

import torch

from . import cuda_chol
from .riccati import spd_factor as _cholesky, spd_solve as _tri_solve


def plain_factor(H: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    L = _cholesky(H)
    return L, 1.0 / torch.diagonal(L, dim1=-2, dim2=-1)


def plain_solve(L: torch.Tensor, dinv: torch.Tensor,
                r: torch.Tensor) -> torch.Tensor:
    del dinv
    return _tri_solve(L, r)


def _device_type(t: torch.Tensor) -> str:
    kind = t.device.type
    if kind not in ("cpu", "cuda"):
        raise ValueError(f"spd_factor/spd_solve: unsupported device {t.device}")
    return kind


def spd_factor(H: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """H (.., n, n) SPD -> (L, dinv)."""
    if _device_type(H) == "cpu":
        return plain_factor(H)
    if H.dim() == 3:
        return cuda_chol.chol_factor(H)
    batch, n = H.shape[:-2], H.shape[-1]
    L, dinv = cuda_chol.chol_factor(H.reshape((math.prod(batch), n, n)))
    return L.reshape(H.shape), dinv.reshape(batch + (n,))


def spd_solve(F, r: torch.Tensor) -> torch.Tensor:
    """Solve against a stored spd_factor pair F = (L, dinv); r (.., n) or
    (.., n, k), batch dims broadcast against L's."""
    L, dinv = F
    if _device_type(L) == "cpu":
        return plain_solve(L, dinv, r)
    vec = r.dim() == L.dim() - 1
    rk = r[..., None] if vec else r
    if L.dim() == rk.dim() == 3 and rk.shape[0] == L.shape[0]:
        X = cuda_chol.chol_sub(L, dinv, rk)
        return X[..., 0] if vec else X
    n, k = L.shape[-1], rk.shape[-1]
    batch = torch.broadcast_shapes(L.shape[:-2], rk.shape[:-2])
    nb = math.prod(batch)
    X = cuda_chol.chol_sub(
        torch.broadcast_to(L, batch + (n, n)).reshape(nb, n, n),
        torch.broadcast_to(dinv, batch + (n,)).reshape(nb, n),
        torch.broadcast_to(rk, batch + (n, k)).reshape(nb, n, k))
    X = X.reshape(batch + (n, k))
    return X[..., 0] if vec else X
