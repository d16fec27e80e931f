"""The roofline counts against hand counts at small shapes, the SPD
shapes of the count table against the tick's own calls, the QP kernel's
count against its WBC's shape and its recorded bound, and each kernel
found in a trace by its whole name."""

from __future__ import annotations

import types

import pytest
import torch

from portbench import gen, spec, trace
from portbench.counts import peaks, resident_ipm, resident_qp, spd_chol


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


def test_qp_work_is_linear_in_the_batch_and_grows_with_iterations():
    b1, f1 = resident_qp.qp_work(1)
    assert resident_qp.qp_work(1024) == (1024 * b1, 1024 * f1)
    b2, f2 = resident_qp.qp_work(1, iters=16)
    assert b2 == b1 and f2 > f1
    b3, f3 = resident_qp.qp_work(1, refine=2)
    assert b3 == b1 and f3 > f1
    # bytes: P, q, A, b, G, h and both masks in; x, y, z, s and 3 status
    # words out, 4 bytes each, and one flag byte
    n, p, m = 30, 30, 68
    assert b1 == 4 * (n * n + n + p * n + p + m * n + m + p + m
                      + n + p + 2 * m + 3) + 1


def test_qp_bound_is_the_recorded_one():
    """The copy gives the bound chip_smoke.py's phase 10 printed for the
    kernel at B = 1 / 64 / 1024 (PERF.md: 0.000054 / 0.0034 / 0.0550 ms,
    set by operations), to the digits printed."""
    for B, ms, digit in ((1, 0.000054, 1e-6), (64, 0.0034, 1e-4),
                         (1024, 0.0550, 1e-4)):
        secs, by = peaks.least_seconds(*resident_qp.qp_work(B))
        assert by == "operations"
        assert abs(secs * 1e3 - ms) <= digit / 2


def test_qp_roofline_share():
    solver = types.SimpleNamespace(iters=15, refine_steps=1)
    need = peaks.least_seconds(*resident_qp.qp_work(1024))[0]
    assert resident_qp.roofline_pct(20, 20 * need / 0.07, 1024,
                                    solver) == pytest.approx(7.0)
    assert resident_qp.roofline_pct(0, 0.0, 1024, solver) is None


def test_qp_shape_is_the_wbcs():
    """qp_work's default (n, p, m) is the shape of the QP the WBC builds,
    in both configurations."""
    from apf_quadruped_tpu_torch import wbc
    for name in ("dogbot_trot", "dogbot_adaptive"):
        conf = spec.cell(f"{name}.sweep_b1024").config
        cfg, rcfg = spec.program_config(conf), spec.reference_config(conf)
        h = gen.wbc_states(rcfg, 2, gen.rng(3, 3))
        st = wbc.WbcState(**{k: torch.as_tensor(h[k]) for k in (
            "p_base", "R_wb", "q", "u", "contact", "crawl", "cone_rot")})
        ref = wbc.WbcRefs(**{k: torch.as_tensor(h[k])
                             for k in wbc.WbcRefs._fields})
        qp, _ = wbc._build_qp(cfg, st, ref)
        assert (qp.q.shape[-1], qp.b.shape[-1], qp.h.shape[-1]) == (30, 30,
                                                                    68)


def _trace(names):
    return trace.Trace(kernels=[(n, 10.0 * i, 10.0 * i + 4.0)
                                for i, n in enumerate(names)],
                       host=[], window_s=1.0, busy_s=0.5, share=1.0, tries=1,
                       lossless=True)


def test_kernels_are_found_by_their_whole_name():
    """The plan's kernel and the WBC's QP kernel, as a profiler names
    them, each counted by its own name only: the one's is a prefix of the
    other's but for `_qp`."""
    tr = _trace(["void (anonymous namespace)::resident_ipm_kernel<float>"
                 "((anonymous namespace)::IpmArgs, float const*)",
                 "resident_ipm_kernel<__nv_bfloat16>(IpmArgs, "
                 "__nv_bfloat16 const*)",
                 "void (anonymous namespace)::resident_ipm_qp_kernel(QpArgs)",
                 "void (anonymous namespace)::resident_ipm_qp_kernel("
                 "QpArgs)", "void (anonymous namespace)::resident_ipm_qp_"
                 "kernel(QpArgs)", "spd_factor_kernel<18>(float const*)"])
    count, secs = trace.seconds_of(tr, resident_ipm.KERNEL)
    assert count == 2 and secs == pytest.approx(8e-6)
    count, secs = trace.seconds_of(tr, resident_qp.KERNEL)
    assert count == 3 and secs == pytest.approx(12e-6)
    assert trace.seconds_of(tr, "resident_ipm") == (0, 0)
