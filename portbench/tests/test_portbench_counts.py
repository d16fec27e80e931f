"""The roofline counts against hand counts at small shapes, and the SPD
shapes of the count table against the tick's own calls."""

from __future__ import annotations

import pytest
import torch

from portbench.counts import peaks, resident_ipm, spd_chol


def test_factor_by_hand():
    # n = 2: sqrt and 1/L for each diagonal (4), L10 = H10 / L00 (1),
    # L11 = sqrt(H11 - L10^2): one multiply-add (2)
    assert spd_chol.factor_work(1, 2)[1] == 7
    # n = 3: diagonals 3 x (sqrt, reciprocal) = 6; below the diagonal
    # 3 multiplies; multiply-adds: L11 1, L21 1, L22 2 -> 8 operations
    assert spd_chol.factor_work(1, 3)[1] == 17
    # bytes: the triangle in (3 floats), the triangle and 1/L_ii out (5)
    assert spd_chol.factor_work(1, 2)[0] == 4 * 8
    assert spd_chol.factor_work(10, 2) == tuple(10 * v for v in
                                                spd_chol.factor_work(1, 2))


def test_substitution_by_hand():
    # n = 2, one column: forward y0 = b0 d0 (1), y1 = (b1 - L10 y0) d1 (3);
    # back the same: 8 = 2 n^2 k
    assert spd_chol.sub_work(1, 2, 1)[1] == 8
    assert spd_chol.sub_work(1, 3, 4)[1] == 2 * 9 * 4
    # L strictly lower (1) and 1/L_ii (2), R in and X out (2 x 2)
    assert spd_chol.sub_work(1, 2, 1)[0] == 4 * (1 + 2 + 4)


def test_knot_flops_by_hand():
    # nx = nu = m = 1: the rollout's x = A x + B u (2 MACs), Q x and A' lam
    # (2), R u + B' lam + G' z (3), G u (1): 8 MACs, 16 operations
    roll, fac, vec = resident_ipm.knot_flops(1, 1, 1)
    assert roll == 16
    # B'P, A'P (2), M's triangle over m + nx (2), B'PA (1), Cholesky
    # 1 // 6 = 0, K (1), P (2): 8 MACs
    assert fac == 16
    # g, kff backward (3), sv (2), du, gdu forward (2), dx (2): 9 MACs
    assert vec == 18


def test_plan_work_counts_the_iterations_run():
    b1, f1 = resident_ipm.plan_work(20, [5, 7], [True, False])
    b2, f2 = resident_ipm.plan_work(20, [10, 14], [True, False])
    roll, fac, vec = resident_ipm.knot_flops(13, 12, 24)
    assert f1 == 20 * ((5 + 7) * (fac + 2 * vec) + (5 + 2 + 7 + 1) * roll)
    assert f2 > f1 and b1 == b2


def test_least_seconds():
    assert peaks.least_seconds(3.35e12, 0.0) == (1.0, "bytes")
    assert peaks.least_seconds(0.0, 67e12) == (1.0, "operations")


def test_tick_shapes_are_the_ticks_calls(monkeypatch):
    """Every (n, k) of an SPD factor or solve in one tick of the program
    (its CPU path, which routes the same calls to the plain versions) is in
    the count table, and each table entry occurs."""
    from apf_quadruped_tpu_torch.ops import chol, qpsolve
    from apf_quadruped_tpu_torch.runtime import loop, sweep
    from apf_quadruped_tpu_torch.sim import physics

    seen = set()
    real_f, real_s = chol.spd_factor, chol.spd_solve

    def factor(H):
        seen.add((H.shape[-1], 0))
        return real_f(H)

    def solve(F, r):
        k = 1 if r.dim() == F[0].dim() - 1 else r.shape[-1]
        seen.add((F[0].shape[-1], k))
        return real_s(F, r)

    for mod in (qpsolve, physics):
        monkeypatch.setattr(mod, "spd_factor", factor)
        monkeypatch.setattr(mod, "spd_solve", solve)
    cfg = sweep.cli_config()
    scn = sweep.random_scenarios(cfg, 2, seed=1, use_native=False,
                                 device="cpu")
    st = sweep.init_batch(cfg, scn)
    head = loop._cycle_head_eager(cfg, st, sweep._terrain(cfg, scn),
                                  scn.target_xy, scn.dist_sched)
    seen.clear()
    loop._tick(cfg, head.cyc, head.carry, torch.zeros(1, dtype=torch.int64))
    assert seen == set(spd_chol.TICK_SHAPES.values())


@pytest.mark.parametrize("key", sorted(spd_chol.TICK_SHAPES))
def test_kernel_work_per_kernel(key):
    nbytes, flops = spd_chol.kernel_work(*key, B=8)
    assert nbytes > 0 and flops > 0
