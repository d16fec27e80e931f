"""Solver diagnostics record of the dense QP solver.

Port of the `QPSolution` NamedTuple of apf_quadruped_tpu/ops/qpsolve.py,
which `planner.plan` returns as `MpcPlan.sol`.  The dense Mehrotra IPM
itself is not ported yet (ROADMAP slice B).
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class QPSolution(NamedTuple):
    x: torch.Tensor          # (..., n) primal
    y: torch.Tensor          # (..., p) equality multipliers
    z: torch.Tensor          # (..., m) inequality multipliers
    s: torch.Tensor          # (..., m) slacks
    converged: torch.Tensor  # (...,) bool — residuals below tolerance
    iters: torch.Tensor      # (...,) int32 — first iteration at which converged
    gap: torch.Tensor        # (...,) final duality measure s'z/m
    res_norm: torch.Tensor   # (...,) final max relative residual norm
