"""SPD factor and solve, plain only.

Frozen from the port's ops/chol.py: the plain versions (cholesky_ex with a
NaN fill where a matrix is not positive definite, two triangular solves),
on whatever device the tensors are.  The kernel routes are left out.
"""

from __future__ import annotations

import torch

from .riccati import spd_factor as _cholesky, spd_solve as _tri_solve


def spd_factor(H: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """H (.., n, n) SPD -> (L, dinv)."""
    L = _cholesky(H)
    return L, 1.0 / torch.diagonal(L, dim1=-2, dim2=-1)


def spd_solve(F, r: torch.Tensor) -> torch.Tensor:
    """M^-1 r from a spd_factor pair; r (.., n) or (.., n, k)."""
    return _tri_solve(F[0], r)


def chol_solve(M: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """M^-1 r for SPD M; NaN where M is not positive definite."""
    return spd_solve(spd_factor(M), r)
