"""The CUDA kernels against their plain versions, on the card: the
resident IPM (csrc/resident_ipm.cu), the SPD factor / substitution /
factor-and-solve (csrc/spd_chol.cu), the fused Riccati passes
(csrc/fused_riccati.cu) and the resident WBC QP (csrc/resident_qp.cu,
held to float64 against the op-by-op chain's own float32 gap); the
closed loop's tick replayed from a
captured CUDA graph (runtime/graph.py) against the eager tick; and
planner.plan and the cycle's head replayed from their graphs against
their eager bodies; wbc.solve and solve_qp replayed from theirs against
theirs.

Every test here needs a CUDA device and skips without one.  The file
imports no JAX (the GPU machine has none) and takes its seed from its own
fixture, so it runs there without tests/conftest.py, which imports jax:

    python -m pytest --noconftest tests/test_torch_cuda.py

Gates are the JAX package's resident-vs-scan gates
(tests/test_pallas_riccati.py): converged and iters exactly equal, u/x at
atol 5e-5 in float32; where the inputs of two solves differ only in
data the solver must ignore, the outputs are equal bit for bit.
"""

import numpy as np
import pytest
import torch

from apf_quadruped_tpu_torch import convert, planner, problems
from apf_quadruped_tpu_torch.config import (EngineConfig, GaitConfig,
                                            MpcConfig, SimConfig,
                                            SolverConfig, WbcConfig)
from apf_quadruped_tpu_torch.ops import cuda_riccati
from apf_quadruped_tpu_torch.ops import riccati as tr

CFG = SolverConfig(iters=15, reltol=1e-4, abstol=1e-4,
                   static_reg=1e-6, w_clip=1e6)
ATOL = 5e-5
VARIANTS = [(warm, mc, acc) for warm in (False, True) for mc in (0, 6)
            for acc in (False, True)]

pytestmark = pytest.mark.cuda


@pytest.fixture
def rng():
    return np.random.default_rng(0)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the resident IPM kernel is built "
                    "with nvcc for sm_90a and has no CPU mode")
    return torch.device("cuda")


def _qp(rng, dev, mc=0, acc=False, **kw):
    # the accel rows assume the 13-state SRB layout
    dims = dict(NX=13, NU=12, M=24) if acc else {}
    return convert.stage_qp(
        problems.random_stage_qp(rng, mc=mc, acc=acc, **(dims | kw)), dev)


def _assert_close(out, ref, atol=ATOL):
    assert torch.equal(out.converged, ref.converged)
    assert torch.equal(out.iters, ref.iters)
    assert float((out.u - ref.u).abs().max()) <= atol
    assert float((out.x - ref.x).abs().max()) <= atol


def _assert_equal(a, b):
    for f in tr.StageSolution._fields:
        x, y = getattr(a, f), getattr(b, f)
        assert (x is None and y is None) or torch.equal(x, y), f


@pytest.mark.parametrize("has_warm,mc,acc", VARIANTS)
def test_kernel_matches_plain(rng, dev, has_warm, mc, acc):
    qp = _qp(rng, dev, mc=mc, acc=acc)
    warm = None
    if has_warm:
        cold = tr.solve_stage_qp(qp, CFG)
        warm = tr.WarmStart(u=cold.u, z=cold.z, s=cold.s,
                            valid=torch.tensor([True, False, True, True],
                                               device=dev))
    ref = tr.solve_stage_qp(qp, CFG, warm)
    before = cuda_riccati.solve_stage_qp_resident.launches
    out = cuda_riccati.solve_stage_qp_resident(qp, CFG, warm)
    assert cuda_riccati.solve_stage_qp_resident.launches == before + 1
    assert out.z.shape == ref.z.shape
    assert (out.zx is None) == (ref.zx is None)
    _assert_close(out, ref)


def test_kernel_over_block_edge(rng, dev):
    """B=130 is not a multiple of the block's 8 scenarios."""
    qp = _qp(rng, dev, B=130, H=3, NX=4, NU=3, M=4)
    _assert_close(cuda_riccati.solve_stage_qp_resident(qp, CFG),
                  tr.solve_stage_qp(qp, CFG), atol=1e-4)


# The kernel stages each knot's records into a two-slot ring while it
# works on the knot before: the cases below are those a ring can break.

@pytest.mark.parametrize("H", [1, 2, 7, 30, 40])
def test_kernel_ring_over_horizons(rng, dev, H):
    """Production widths (13 states, 12 inputs, 24 rows) with 6 state rows
    and the accel rows: one knot (no copy in flight behind it), two (each
    slot once), an odd horizon (the sweeps end on the other slot than they
    start) and long ones (40: the crawl plan's)."""
    qp = _qp(rng, dev, mc=6, acc=True, H=H, a_noise=0.03)
    _assert_close(cuda_riccati.solve_stage_qp_resident(qp, CFG),
                  tr.solve_stage_qp(qp, CFG))


@pytest.mark.parametrize("B", [1, 9, 2049])
def test_kernel_batch_off_the_block(rng, dev, B):
    """A batch of one scenario, and batches one past a multiple of the
    block's 8 scenarios, whose spare warps leave before any work.  The
    2049 lanes repeat 9 problems: every copy of a problem comes back
    equal bit for bit, whichever block and warp ran it."""
    q = problems.random_stage_qp(rng, B=min(B, 9), H=5, NX=13, NU=12, M=24,
                                 mc=6, acc=True)
    lanes = np.arange(B) % 9 if B > 9 else np.arange(B)
    q = {k: v[lanes] if k in ("A", "B", "qlin", "mask", "x0", "cx", "mask_x")
         else v for k, v in q.items()}
    qp = convert.stage_qp(q, dev)
    out = cuda_riccati.solve_stage_qp_resident(qp, CFG)
    _assert_close(out, tr.solve_stage_qp(qp, CFG))
    first = torch.as_tensor(lanes, device=dev)
    for f in ("u", "x", "z", "s", "zx", "sx", "iters"):
        assert torch.equal(getattr(out, f), getattr(out, f)[first]), f


def test_kernel_block_lanes_stop_apart(rng, dev):
    """Warm and cold lanes mixed in each block of 8: warm lanes converge
    iterations before their neighbours and leave the loop, the others run
    on."""
    qp = _qp(rng, dev, B=16, mc=6, acc=True, H=7)
    cold = tr.solve_stage_qp(qp, CFG)
    valid = torch.arange(16, device=dev) % 3 == 0
    warm = tr.WarmStart(u=cold.u, z=cold.z, s=cold.s, valid=valid)
    ref = tr.solve_stage_qp(qp, CFG, warm)
    out = cuda_riccati.solve_stage_qp_resident(qp, CFG, warm)
    assert len(set(ref.iters[:8].tolist())) > 1
    _assert_close(out, ref)


def test_kernel_every_iteration_without_tolerance(rng, dev):
    """reltol = abstol = 0: no lane converges, every lane runs all the
    iterations and ends on the last measure, as the plain version does."""
    cfg = SolverConfig(iters=6, reltol=0.0, abstol=0.0, static_reg=1e-6,
                       w_clip=1e6)
    qp = _qp(rng, dev, mc=6, acc=True, H=7)
    out = cuda_riccati.solve_stage_qp_resident(qp, cfg)
    assert bool((out.iters == 6).all()) and not bool(out.converged.any())
    _assert_close(out, tr.solve_stage_qp(qp, cfg))


@pytest.mark.parametrize("H", [10, 30, 40])
def test_kernel_plan_horizons(dev, H):
    """The BASELINE horizons beside H=20, and the crawl plan's 40, on the
    planner's own stage QP with
    the base_box state rows and the base_acc accel rows: the iterations of
    the plain version on every lane, u (forces of O(100) N) within the
    plan gate, 1e-3 of the largest force."""
    cfg = EngineConfig(mpc=MpcConfig(horizon=H, dt=0.025, base_box=True,
                                     base_acc=True), solver=SolverConfig())
    x0, refs = problems.bench_problem(cfg, 16, device=dev)
    qp = planner.stage_qp(cfg, x0, refs)
    ref = tr.solve_stage_qp(qp, cfg.solver)
    _assert_close(cuda_riccati.solve_stage_qp_resident(qp, cfg.solver), ref,
                  atol=1e-3 * max(1.0, float(ref.u.abs().max())))


def test_kernel_nan_lane_quarantined(rng, dev):
    """A poisoned lane comes back zeroed, unconverged, after every
    iteration, with gap and residual inf, as from the plain version; the
    other lanes are unaffected."""
    qp = _qp(rng, dev)
    x0 = qp.x0.clone()
    x0[1, 0] = float("nan")
    qp = qp._replace(x0=x0)
    ref = tr.solve_stage_qp(qp, CFG)
    out = cuda_riccati.solve_stage_qp_resident(qp, CFG)
    assert bool(torch.isfinite(out.u).all() & torch.isfinite(out.z).all())
    assert bool((out.u[1] == 0).all() & (out.x[1] == 0).all())
    assert int(out.iters[1]) == CFG.iters
    assert float(out.gap[1]) == float(out.res_norm[1]) == float("inf")
    _assert_close(out, ref)
    assert torch.equal(out.gap.isinf(), ref.gap.isinf())


def test_kernel_masked_rows_inert(rng, dev):
    """Moving G and h of a row that every knot masks changes nothing."""
    qp = _qp(rng, dev, mask_frac=0.5)
    mask = qp.mask.clone()
    mask[..., 0] = 0.0
    qp = qp._replace(mask=mask)
    base = cuda_riccati.solve_stage_qp_resident(qp, CFG)
    G, h = qp.G.clone(), qp.h.clone()
    G[0] *= -3.0
    h[0] = 0.01
    _assert_equal(cuda_riccati.solve_stage_qp_resident(
        qp._replace(G=G, h=h), CFG), base)


@pytest.mark.parametrize("mc,acc", [(0, False), (6, True)])
def test_kernel_invalid_warm_start_equals_cold(rng, dev, mc, acc):
    qp = _qp(rng, dev, mc=mc, acc=acc)
    cold = cuda_riccati.solve_stage_qp_resident(qp, CFG)
    B, H, nu = qp.B.shape[0], qp.B.shape[1], qp.B.shape[-1]
    mt = cold.z.shape[-1]
    off = tr.WarmStart(u=torch.full((B, H, nu), 3.0, device=dev),
                       z=torch.full((B, H, mt), 5.0, device=dev),
                       s=torch.full((B, H, mt), 7.0, device=dev),
                       valid=torch.zeros(B, dtype=torch.bool, device=dev))
    _assert_equal(cuda_riccati.solve_stage_qp_resident(qp, CFG, off), cold)


def test_kernel_unbatched(rng, dev):
    """Scalar batch shape () round-trips through the flat batch axis."""
    qp = _qp(rng, dev)
    qp1 = qp._replace(A=qp.A[0], B=qp.B[0], qlin=qp.qlin[0],
                      mask=qp.mask[0], x0=qp.x0[0])
    out = cuda_riccati.solve_stage_qp_resident(qp1, CFG)
    assert out.converged.shape == () and out.u.shape == (5, 4)
    _assert_close(out, tr.solve_stage_qp(qp1, CFG))


def test_kernel_rejects_what_it_does_not_take(rng, dev):
    qp = _qp(rng, dev)
    with pytest.raises(TypeError, match="float32"):
        cuda_riccati.solve_stage_qp_resident(qp._replace(x0=qp.x0.double()),
                                             CFG)
    wide = _qp(rng, dev, NX=14)
    with pytest.raises(ValueError, match="nx<=13"):
        cuda_riccati.solve_stage_qp_resident(wide, CFG)


def test_plan_auto_runs_the_kernel(dev):
    """plan() on CUDA tensors goes through the kernel under backend auto
    and agrees with the plain plan on the card."""
    cfg = EngineConfig(mpc=MpcConfig(horizon=20, dt=0.025),
                       solver=SolverConfig())
    x0, refs = problems.bench_problem(cfg, 8, device=dev)
    before = cuda_riccati.solve_stage_qp_resident.launches
    out = planner.plan(cfg, x0, refs)
    assert cuda_riccati.solve_stage_qp_resident.launches == before + 1
    plain = planner.plan(EngineConfig(
        mpc=MpcConfig(horizon=20, dt=0.025, backend="riccati"),
        solver=SolverConfig()), x0, refs)
    assert torch.equal(out.sol.iters, plain.sol.iters)
    assert bool(out.sol.converged.all())
    ftol = 1e-3 * max(1.0, float(plain.forces.abs().max()))
    assert float((out.forces - plain.forces).abs().max()) <= ftol


# ---------------------------------------------------------------------------
# the SPD factor / substitution kernels (csrc/spd_chol.cu) against their
# plain versions (ops/chol.py: cholesky_ex + triangular solves, here on the
# card).  Gate: 1e-5 relative to the largest entry on well-conditioned SPD
# input (A A' + n I), a few float32 roundings of n-term sums.
# ---------------------------------------------------------------------------

from apf_quadruped_tpu_torch.ops import chol, cuda_chol  # noqa: E402
from apf_quadruped_tpu_torch.ops import cuda_qp, qpsolve  # noqa: E402


def _qp_counts():
    """The launch counters of the SPD kernels and the resident QP kernel."""
    return np.array([f.launches for f in (
        cuda_chol.chol_factor, cuda_chol.chol_sub, cuda_chol.chol_solve,
        cuda_qp.solve_qp_resident)])


def _spd(rng, B, n, dev):
    A = rng.normal(size=(B, n, n))
    return torch.as_tensor(A @ A.transpose(0, 2, 1) + n * np.eye(n),
                           dtype=torch.float32, device=dev)


def _rel(a, b):
    return float((a - b).abs().max() / b.abs().max())


# The kernels compile to two widths, 18 and 30: n <= 18 runs at 18 and
# 19 <= n <= 30 at 30, padded with an identity block; 31 <= n <= 64 takes
# the wide bodies (runtime n).  k < 8 runs lanes over rows, k >= 8 lanes
# over the right-hand sides, 32 at a time.  The sizes below sit on each
# edge; the batches on either side of the loop's 64.
@pytest.mark.parametrize("n", [1, 2, 17, 18, 19, 29, 30, 31, 32, 33, 64])
@pytest.mark.parametrize("B", [1, 63, 64, 65, 1030])
@pytest.mark.parametrize("k", [1, 2, 7, 8, 30, 33])
def test_spd_kernels_match_plain(rng, dev, n, B, k):
    H = _spd(rng, B, n, dev)
    r = torch.as_tensor(rng.normal(size=(B, n, k)), dtype=torch.float32,
                        device=dev)
    before = (cuda_chol.chol_factor.launches, cuda_chol.chol_sub.launches)
    L, d = chol.spd_factor(H)
    X = chol.spd_solve((L, d), r)
    assert (cuda_chol.chol_factor.launches, cuda_chol.chol_sub.launches) \
        == (before[0] + 1, before[1] + 1)
    Lp, dp = chol.plain_factor(H)
    Xp = chol.plain_solve(Lp, dp, r)
    assert _rel(L, Lp) <= 1e-5 and _rel(d, dp) <= 1e-5
    assert _rel(X, Xp) <= 1e-5
    assert bool((torch.triu(L, 1) == 0).all())
    # a vector right-hand side takes the same kernel, as k = 1
    assert torch.equal(chol.spd_solve((L, d), r[..., 0]),
                       chol.spd_solve((L, d), r[..., :1])[..., 0])


def test_spd_kernels_nan_lane(rng, dev):
    """A matrix that is not positive definite comes back NaN, all of it,
    as from the plain version; the other lanes are untouched."""
    H = _spd(rng, 6, 30, dev)
    H[4, 10, 10] = -1.0
    L, d = chol.spd_factor(H)
    X = chol.spd_solve((L, d), torch.ones(6, 30, device=dev))
    Lp, dp = chol.plain_factor(H)
    for t in (L[4], d[4], X[4], Lp[4], dp[4]):
        assert bool(t.isnan().all())
    ok = [0, 1, 2, 3, 5]
    assert bool(L[ok].isfinite().all() & X[ok].isfinite().all())
    assert _rel(L[ok], Lp[ok]) <= 1e-5


def test_spd_kernels_batch_shapes_and_strides(rng, dev):
    """Unbatched and multi-axis batches, and non-contiguous inputs, give
    the kernel on a contiguous (B, n, n) batch's answer."""
    H = _spd(rng, 12, 18, dev)
    r = torch.as_tensor(rng.normal(size=(12, 18, 5)), dtype=torch.float32,
                        device=dev)
    L, d = chol.spd_factor(H)
    X = chol.spd_solve((L, d), r)
    L1, d1 = chol.spd_factor(H[3])
    assert torch.equal(L1, L[3]) and torch.equal(d1, d[3])
    L2, d2 = chol.spd_factor(H.reshape(3, 4, 18, 18))
    assert torch.equal(L2.reshape(12, 18, 18), L)
    assert torch.equal(chol.spd_solve((L2, d2), r.reshape(3, 4, 18, 5))
                       .reshape(12, 18, 5), X)
    # transposed (H is symmetric) and strided right-hand sides
    Lt, dt = chol.spd_factor(H.transpose(-1, -2))
    assert torch.equal(Lt, L) and torch.equal(dt, d)
    wide = torch.zeros(12, 18, 10, device=dev)
    wide[..., ::2] = r
    assert torch.equal(chol.spd_solve((L, d), wide[..., ::2]), X)


@pytest.mark.parametrize("n", [2, 17, 18, 19, 30, 64])
def test_spd_kernels_bad_lanes_leave_the_rest(rng, dev, n):
    """A lane that is not positive definite and a lane with a NaN below the
    diagonal come back all NaN from the factor and the substitution; every
    other lane is bit for bit what it is in a batch without them."""
    H = _spd(rng, 9, n, dev)
    r = torch.as_tensor(rng.normal(size=(9, n, 3)), dtype=torch.float32,
                        device=dev)
    L0, d0 = cuda_chol.chol_factor(H)
    X0 = cuda_chol.chol_sub(L0, d0, r)
    bad = H.clone()
    bad[2, n - 1, n - 1] = -1.0
    bad[6, n - 1, 0] = bad[6, 0, n - 1] = float("nan")
    L, d = cuda_chol.chol_factor(bad)
    X = cuda_chol.chol_sub(L, d, r)
    for lane in (2, 6):
        assert bool(L[lane].isnan().all() & d[lane].isnan().all()
                    & X[lane].isnan().all())
    ok = [0, 1, 3, 4, 5, 7, 8]
    assert torch.equal(L[ok], L0[ok]) and torch.equal(d[ok], d0[ok])
    assert torch.equal(X[ok], X0[ok])


@pytest.mark.parametrize("n", [5, 18, 19, 30, 31, 64])
def test_spd_factor_reads_the_lower_triangle_only(rng, dev, n):
    """Anything in H's strict upper triangle, NaN included, leaves L and
    dinv unchanged bit for bit."""
    H = _spd(rng, 4, n, dev)
    L, d = cuda_chol.chol_factor(H)
    upper = torch.triu(torch.ones(n, n, dtype=torch.bool, device=dev), 1)
    junk = torch.as_tensor(rng.normal(size=(4, n, n)) * 1e3,
                           dtype=torch.float32, device=dev)
    junk[1] = float("nan")
    L2, d2 = cuda_chol.chol_factor(torch.where(upper, junk, H))
    assert torch.equal(L2, L) and torch.equal(d2, d)


@pytest.mark.parametrize("n", [18, 30, 64])
@pytest.mark.parametrize("k", [1, 30])
def test_spd_kernels_lanes_are_independent(rng, dev, n, k):
    """One lane's L and X are bit for bit the same whatever its batch
    neighbours hold, and alone in a batch of one."""
    H = _spd(rng, 65, n, dev)
    r = torch.as_tensor(rng.normal(size=(65, n, k)), dtype=torch.float32,
                        device=dev)
    L, d = cuda_chol.chol_factor(H)
    X = cuda_chol.chol_sub(L, d, r)
    H2, r2 = _spd(rng, 65, n, dev), torch.randn_like(r)
    H2[40], r2[40] = H[40], r[40]
    L2, d2 = cuda_chol.chol_factor(H2)
    X2 = cuda_chol.chol_sub(L2, d2, r2)
    L1, d1 = cuda_chol.chol_factor(H[40:41])
    X1 = cuda_chol.chol_sub(L1, d1, r[40:41])
    for Lo, do, Xo in ((L2[40], d2[40], X2[40]), (L1[0], d1[0], X1[0])):
        assert torch.equal(Lo, L[40]) and torch.equal(do, d[40])
        assert torch.equal(Xo, X[40])


@pytest.mark.parametrize("n", [18, 30])
def test_spd_kernels_unaligned_buffers(rng, dev, n):
    """Operands that do not start on a 16-byte boundary (a contiguous view
    one float into its storage) are staged row by row instead of with
    16-byte copies, with the same answer bit for bit."""
    H = _spd(rng, 5, n, dev)
    L, d = cuda_chol.chol_factor(H)
    r = torch.as_tensor(rng.normal(size=(5, n, 1)), dtype=torch.float32,
                        device=dev)
    X = cuda_chol.chol_sub(L, d, r)
    Hs = torch.empty(H.numel() + 1, device=dev)
    Hs[1:] = H.reshape(-1)
    Hu = Hs[1:].view(H.shape)
    assert Hu.data_ptr() % 16 != 0 and Hu.is_contiguous()
    Lu, du = cuda_chol.chol_factor(Hu)
    assert torch.equal(Lu, L) and torch.equal(du, d)
    Ls = torch.empty(L.numel() + 1, device=dev)
    Ls[1:] = L.reshape(-1)
    assert torch.equal(cuda_chol.chol_sub(Ls[1:].view(L.shape), d, r), X)


def test_spd_kernels_reject_what_they_do_not_take(rng, dev):
    with pytest.raises(ValueError, match="n <= 64"):
        cuda_chol.chol_factor(_spd(rng, 2, 65, dev))
    with pytest.raises(ValueError, match="n <= 64"):
        cuda_chol.chol_solve(_spd(rng, 2, 65, dev),
                             torch.ones(2, 65, 1, device=dev))
    with pytest.raises(TypeError, match="float32"):
        chol.spd_factor(_spd(rng, 2, 8, dev).double())
    with pytest.raises(ValueError, match="CUDA"):
        cuda_chol.chol_factor(_spd(rng, 2, 8, "cpu"))


def test_solve_qp_kernel_route(rng, dev):
    """solve_qp on CUDA tensors at the WBC's sizes is one launch of the
    resident QP kernel (no SPD kernel) and agrees with the plain route (CPU
    tensors) on WBC-shaped QPs."""
    B, n, m, p = 64, 30, 68, 30
    M = rng.normal(size=(B, n, n))
    G = rng.normal(size=(B, m, n))
    x0 = rng.normal(size=(B, n)) * 0.1
    A = rng.normal(size=(B, p, n))
    data = dict(P=np.einsum("bij,bkj->bik", M, M) / n + 0.5 * np.eye(n),
                q=rng.normal(size=(B, n)), G=G,
                h=np.einsum("bmn,bn->bm", G, x0)
                + rng.uniform(0.1, 1.0, (B, m)),
                A=A, b=np.einsum("bpn,bn->bp", A, x0),
                eq_mask=np.repeat([[1.0] * 18 + [0.0] * 12], B, axis=0),
                ineq_mask=np.ones((B, m)))
    data = {k: v.astype(np.float32) for k, v in data.items()}
    before = _qp_counts()
    sol = qpsolve.solve_qp(convert.qp_data(data, dev), SolverConfig())
    assert tuple(_qp_counts() - before) == (0, 0, 0, 1)
    ref = qpsolve.solve_qp(convert.qp_data(data, "cpu"), SolverConfig())
    agree = ((sol.converged.cpu() == ref.converged)
             & (sol.iters.cpu() == ref.iters))
    assert float(agree.float().mean()) >= 0.95
    assert bool(ref.converged.all())
    dx = (sol.x.cpu() - ref.x).abs().amax(dim=-1)[agree]
    assert float(dx.max()) <= 1e-3 * (1.0 + float(ref.x.abs().max()))


# ---------------------------------------------------------------------------
# the resident QP kernel (csrc/resident_qp.cu via ops/cuda_qp.py) against
# float64 and against the chain it replaces (_solve_qp_impl on the card)
# ---------------------------------------------------------------------------

# The kernel's distance from the float64 solve, per lane and output (the
# largest entry's, over 1 + the float64 answer's largest entry), against
# the chain route's own float32 distance on the same lanes (those where
# both stop at float64's iteration): at each quantile below, at most QP_GAP
# times the chain's plus 1e-6.  The two routes sum in other orders, so on
# the ill-conditioned QPs either may land nearer float64 on a given lane;
# a batch's worst lanes (one in a hundred at B = 64) are a draw of those
# and are left out.
QP_GAP = 4.0
QP_QUANTILES = {1: (0.5,), 64: (0.5, 0.9), 1024: (0.5, 0.9, 0.99)}
# Every lane, the worst too: the kernel's x, y, z and s put into the QP as
# it was given (P, A, G, q, b, h and the masks, in float64) leave residuals
# within QP_GAP of the larger of the kernel's own residual and the chain's
# on that lane (and 1e-5: float32's rounding of the products), and s'z / m
# within 1e-5 (1 + gap) of the gap the kernel reports.  A lane that solved
# some other QP (a fault in its staging or indexing) reports its own QP's
# small residuals; the QP it was given shows them large.
QP_FLOOR = 1e-5
# a lane whose iteration count or flag differs from float64's stops where
# the chain's float32 run stops, or is at the tolerance margin: at the
# earlier stop, float64's or the kernel's own max(res / reltol,
# gap / abstol) lies within this factor of 1 (float32's residual floor can
# hold a lane an iteration past float64's stop)
QP_MARGIN = 4.0


def _wbc_qp_case(case, B, dev, seed=0):
    """(SolverConfig, the WBC's QP in float32 on the card): "trot" the
    latency benchmark's states (problems.wbc_problem: all four feet in
    contact); "crawl" one foot in swing and the crawl weight, its pyramid
    rows masked; "anymal" the zoo quadruped's WBC, trotting on the
    diagonal pair."""
    from apf_quadruped_tpu_torch import wbc
    from apf_quadruped_tpu_torch.models import zoo
    cfg = (zoo.engine_config_for("anymal") if case == "anymal"
           else EngineConfig(wbc=WbcConfig(slack_weight_trot=1e6)))
    st, ref = problems.wbc_problem(cfg, B, seed=seed, device=dev)
    gen = torch.Generator(dev).manual_seed(seed)
    if case == "crawl":
        st = st._replace(contact=torch.tensor([1.0, 1.0, 0.0, 1.0],
                                              device=dev).expand(B, 4),
                         crawl=torch.ones(B, dtype=torch.bool, device=dev))
    elif case == "anymal":
        st = st._replace(contact=torch.tensor([1.0, 0.0, 0.0, 1.0],
                                              device=dev).expand(B, 4))
    ref = ref._replace(
        com_pos=ref.com_pos + torch.tensor([0.0, 0.02, -0.03], device=dev),
        com_vel=torch.randn(B, 3, generator=gen, device=dev) * 0.1,
        swing_pos=torch.randn(B, 4, 3, generator=gen, device=dev) * 0.02)
    from apf_quadruped_tpu_torch._precision import highest_precision
    with highest_precision():
        qp, _ = wbc._build_qp(cfg, st, ref)
    return cfg.solver, qp


def _chain(qp, cfg):
    """The op-by-op route on the card (the SPD kernels and the glue)."""
    from apf_quadruped_tpu_torch._precision import highest_precision
    with highest_precision():
        return qpsolve._solve_qp_impl(qp, cfg)


def _stop_margin(qp, cfg, lanes, stops, solve):
    """max(res / reltol, gap / abstol) of each lane in `lanes` of `qp`
    after its iteration `stops` (the earlier of two stops), solved by
    `solve`."""
    import dataclasses
    out = []
    for lane, k in zip(lanes, stops):
        one = qpsolve.QPData(*(v[lane:lane + 1] for v in qp))
        r = solve(one, dataclasses.replace(cfg, iters=k))
        out.append(max(float(r.res_norm[0]) / cfg.reltol,
                       float(r.gap[0]) / cfg.abstol))
    return out


def _given_residuals(qp64, s):
    """(res_norm, s'z / m) of solution `s` put into the float64 QP `qp64` as
    it was given, as _solve_qp_impl measures them."""
    q = qpsolve._apply_masks(qp64)
    x, y, z, sl = (getattr(s, f).double().cpu() for f in ("x", "y", "z", "s"))
    rx = (q.P @ x[..., None])[..., 0] + q.q + (y[..., None, :] @ q.A)[..., 0, :] \
        + (z[..., None, :] @ q.G)[..., 0, :]
    ry = (q.A @ x[..., None])[..., 0] - q.b
    rz = (q.G @ x[..., None])[..., 0] + sl - q.h

    def rel(r, v):
        return r.norm(dim=-1) / (1.0 + v.norm(dim=-1))
    res = torch.maximum(rel(rx, q.q), torch.maximum(rel(ry, q.b),
                                                    rel(rz, q.h)))
    m = torch.clamp(q.ineq_mask.sum(-1), min=1.0)
    return res, (sl * z * q.ineq_mask).sum(-1) / m


def _hold_to_float64(sol, qp, cfg, what):
    """The kernel's solution held to float64 against the chain's float32
    gap (QP_GAP at QP_QUANTILES), every lane's residuals in the QP as given
    against its own and the chain's (QP_GAP, QP_FLOOR), and its iterations
    and flags to float64's but at the margin (QP_MARGIN), no more such
    lanes than twice the chain's and 2% of the batch; returns the lanes at
    the margin."""
    qp64 = qpsolve.QPData(*(v.double().cpu() for v in qp))
    r = qpsolve._solve_qp_impl(qp64, cfg)
    c = _chain(qp, cfg)
    res_k, mu_k = _given_residuals(qp64, sol)
    res_c, _ = _given_residuals(qp64, c)
    own = sol.res_norm.double().cpu()
    bound = QP_GAP * torch.maximum(torch.maximum(own, res_c),
                                   torch.full_like(own, QP_FLOOR))
    gap = sol.gap.double().cpu()
    far = ((res_k > bound)
           | ((mu_k - gap).abs() > QP_FLOOR * (1.0 + gap))).nonzero()[:, 0]
    assert len(far) == 0, (what, [
        (int(b), float(res_k[b]), float(own[b]), float(res_c[b]),
         float(mu_k[b]), float(gap[b])) for b in far])
    k_it, c_it = sol.iters.cpu(), c.iters.cpu()
    both = (k_it == r.iters) & (c_it == r.iters)
    B = qp.q.shape[0]
    for f in ("x", "y", "z", "s"):
        ref = getattr(r, f)
        scale = 1.0 + ref.abs().amax(-1)
        dk = ((getattr(sol, f).double().cpu() - ref).abs().amax(-1)
              / scale)[both]
        dc = ((getattr(c, f).double().cpu() - ref).abs().amax(-1)
              / scale)[both]
        if len(dk) == 0:
            continue
        for q in QP_QUANTILES[B]:
            gk, gc = float(torch.quantile(dk, q)), float(torch.quantile(dc, q))
            assert gk <= QP_GAP * gc + 1e-6, (what, f, q, gk, gc)

    def off(s):
        return (s.iters.cpu() != r.iters) | (s.converged.cpu() != r.converged)

    lanes = off(sol).nonzero()[:, 0]
    stops = torch.minimum(k_it, r.iters)[lanes].tolist()
    m64 = _stop_margin(qp64, cfg, lanes.tolist(), stops,
                       qpsolve._solve_qp_impl)
    mk = _stop_margin(qp, cfg, lanes.tolist(), stops,
                      qpsolve._solve_qp_eager)
    for lane, k, a, b in zip(lanes.tolist(), stops, m64, mk):
        as_chain = (k_it[lane] == c_it[lane]
                    and sol.converged[lane].cpu() == c.converged[lane].cpu())
        print(f"{what}: lane {lane} stops at {int(k_it[lane])} (float64 "
              f"{int(r.iters[lane])}, chain {int(c_it[lane])}); the margin "
              f"at {k}: float64 {a:.3f}, kernel {b:.3f}")
        assert bool(as_chain) or any(1.0 / QP_MARGIN <= v <= QP_MARGIN
                                     for v in (a, b)), (what, lane, a, b)
    n_chain = int(off(c).sum())
    assert len(lanes) <= 2 * n_chain + max(2, 0.02 * B), (what, len(lanes),
                                                          n_chain)
    return lanes.tolist()


@pytest.mark.parametrize("B", [1, 64, 1024])
@pytest.mark.parametrize("case", ["trot", "crawl", "anymal"])
def test_resident_qp_holds_to_float64(dev, case, B):
    """The kernel's x, y, z and s lie as near the float64 solve as the
    chain's float32 answer (QP_GAP at QP_QUANTILES), on the WBC's QPs: trot
    (all four feet in contact), crawl (a swing foot's rows masked) and a zoo
    quadruped; iterations and flags agree with float64's but at the margin,
    those lanes listed."""
    cfg, qp = _wbc_qp_case(case, B, dev)
    before = _qp_counts()
    sol = qpsolve._solve_qp_eager(qp, cfg)
    assert tuple(_qp_counts() - before) == (0, 0, 0, 1)
    assert bool(torch.isfinite(sol.x).all()) and sol.iters.dtype == torch.int32
    _hold_to_float64(sol, qp, cfg, f"{case} B={B}")


@pytest.mark.parametrize("kind", ["no equality rows", "small", "m odd"])
def test_resident_qp_padded_sizes(rng, dev, kind):
    """Sizes under the compiled widths (zero-padded to them by the wrapper
    before the kernel stages them): a make_qp QP with one masked equality
    row, n = 5, p = 2, m = 7, and m odd; held to float64 as the WBC's
    QPs."""
    B = 64
    if kind == "no equality rows":
        qp = _free_qp(rng, B, dev)
    else:
        n, p, m = (5, 2, 7) if kind == "small" else (30, 12, 67)
        M = rng.normal(size=(B, n, n))
        G = rng.normal(size=(B, m, n))
        x0 = rng.normal(size=(B, n)) * 0.1
        A = rng.normal(size=(B, p, n))
        qp = qpsolve.make_qp(*(torch.as_tensor(v, dtype=torch.float32,
                                               device=dev) for v in (
            np.einsum("bij,bkj->bik", M, M) / n + np.eye(n),
            rng.normal(size=(B, n)), G,
            np.einsum("bmn,bn->bm", G, x0) + rng.uniform(0.1, 1.0, (B, m)),
            A, np.einsum("bpn,bn->bp", A, x0))))
    assert cuda_qp.takes(qp)
    cfg = SolverConfig()
    _hold_to_float64(qpsolve._solve_qp_eager(qp, cfg), qp, cfg, kind)


def test_resident_qp_layouts_are_bit_for_bit(dev):
    """One lane's answer is the same bits whatever else is in the batch and
    however the inputs lie: a batch of 2 x 32 against its flat 64, a lane
    alone, and inputs 4 bytes off their alignment (which the wrapper
    copies into an aligned buffer for the kernel's 16-byte cp.async)."""
    cfg, qp = _wbc_qp_case("crawl", 64, dev)
    flat = qpsolve._solve_qp_eager(qp, cfg)
    two = qpsolve._solve_qp_eager(
        qpsolve.QPData(*(v.reshape((2, 32) + v.shape[1:]) for v in qp)), cfg)
    for a, b in zip(flat, two):
        assert torch.equal(a, b.reshape(a.shape))
    one = qpsolve._solve_qp_eager(qpsolve.QPData(*(v[5] for v in qp)), cfg)
    for a, b in zip(flat, one):
        assert torch.equal(a[5], b)

    def shifted(v):
        buf = torch.empty(v.numel() + 1, dtype=v.dtype, device=dev)
        out = buf[1:].view(v.shape)
        out.copy_(v)
        return out
    odd = qpsolve.QPData(*(shifted(v) for v in qp))
    assert odd.P.data_ptr() % 16 != 0
    for a, b in zip(flat, qpsolve._solve_qp_eager(odd, cfg)):
        assert torch.equal(a, b)


def test_resident_qp_quarantines_bad_lanes(dev):
    """A lane whose H is not positive definite and a lane with a NaN in q
    come back zero, unconverged, their gap and residual inf, as the chain
    returns them; the other lanes are the bits of the batch without them."""
    cfg, qp = _wbc_qp_case("trot", 8, dev, seed=1)
    P = qp.P.clone()
    P[2] = -1e6 * torch.eye(30, device=dev)
    q = qp.q.clone()
    q[5, 0] = float("nan")
    bad = qp._replace(P=P, q=q)
    sol = qpsolve._solve_qp_eager(bad, cfg)
    ref = _chain(bad, cfg)
    good = qpsolve._solve_qp_eager(qp, cfg)
    for lane in (2, 5):
        assert not bool(sol.converged[lane]) and not bool(ref.converged[lane])
        for f in ("x", "y", "z", "s"):
            assert bool((getattr(sol, f)[lane] == 0).all()), (lane, f)
            assert bool((getattr(ref, f)[lane] == 0).all()), (lane, f)
        assert float(sol.gap[lane]) == float(ref.gap[lane]) == float("inf")
    rest = [0, 1, 3, 4, 6, 7]
    for a, b in zip(sol, good):
        assert torch.equal(a[rest], b[rest])


def test_closed_loop_runs_through_the_kernels(dev):
    """A short closed-loop cycle (20 ticks) on the card launches the SPD
    kernels and the resident IPM and stays finite and upright.  Its ticks
    are replays of one captured graph (runtime/graph.py), and the launch
    counters count the kernels each replay launches."""
    from apf_quadruped_tpu_torch.runtime import graph, sweep
    cfg = sweep.cli_config()
    cfg = cfg.replace(gait=GaitConfig(mode="trot", trot_cycle=0.05))
    scn = sweep.random_scenarios(cfg, 4, seed=0, use_native=False,
                                 device=dev)
    graph.clear()
    before = (cuda_chol.chol_factor.launches, cuda_chol.chol_sub.launches,
              cuda_riccati.solve_stage_qp_resident.launches,
              cuda_qp.solve_qp_resident.launches)
    res = sweep.run_batch(cfg, scn, 1)
    after = (cuda_chol.chol_factor.launches, cuda_chol.chol_sub.launches,
             cuda_riccati.solve_stage_qp_resident.launches,
             cuda_qp.solve_qp_resident.launches)
    # per tick: the 4 mass-matrix factors and solves of physics' substeps,
    # and one resident QP launch, the whole WBC solve (no n = 30 factor)
    assert after[0] - before[0] == 20 * 4
    (entry,) = _ticks()
    assert entry.launches[0] == 4 and entry.launches[1] == 4
    assert entry.launches[-1] == 1
    assert after[1] - before[1] == 20 * entry.launches[1]
    assert after[2] == before[2] + 1 and after[3] - before[3] == 20
    # the cycle's head (its graph holds the plan): one resident launch;
    # its tail none
    from apf_quadruped_tpu_torch.runtime import loop
    (head,) = [e for e in _calls() if isinstance(e.outs, loop._CycleHead)]
    assert head.launches[3] == 1 and sum(head.launches) == 1
    assert len(_calls()) == 2 and sum(map(sum, (e.launches for e in
                                                _calls()))) == 1
    assert bool(torch.isfinite(res.final_com).all())
    assert bool((res.upright > 0.98).all())


def _small_cfg():
    """tests/test_sweep.py's small plumbing config for the sweep drivers."""
    return EngineConfig(gait=GaitConfig(trot_cycle=0.1),
                        mpc=MpcConfig(horizon=4, dt=0.025),
                        sim=SimConfig(substeps=1, terrain_res=16),
                        solver=SolverConfig(iters=5),
                        wbc=WbcConfig(slack_weight_trot=1e6))


def _leaves(tree):
    if isinstance(tree, torch.Tensor):
        return [tree]
    return [x for v in tree if v is not None for x in _leaves(v)]


def test_resumable_sweep_survives_kill_on_the_card(dev, tmp_path):
    """run_resumable stopped after its first chunk and resumed from the
    checkpoint equals the uninterrupted run bit for bit on the card."""
    from apf_quadruped_tpu_torch.runtime import sweep
    cfg = _small_cfg()
    scn = sweep.random_scenarios(cfg, 4, seed=7, use_native=False,
                                 device=dev)
    ref = sweep.run_resumable(cfg, scn, 4, chunk=2)
    with pytest.raises(RuntimeError, match="simulated preemption"):
        sweep.run_resumable(cfg, scn, 4, chunk=2, ckpt_dir=tmp_path,
                            _crash_after=1)
    out = sweep.run_resumable(cfg, scn, 4, chunk=2, ckpt_dir=tmp_path)
    for a, b in zip(_leaves(out), _leaves(ref)):
        assert a.is_cuda and a.dtype == b.dtype and torch.equal(a, b)


def test_sharded_sweep_on_one_card(dev):
    """run_sharded over ["cuda:0", "cuda:0"] (two halves of the batch on
    one card) against run_batch: the whole batch gathered, the stats its
    means, the final CoM within tests/test_sweep.py's gate."""
    from apf_quadruped_tpu_torch.runtime import sweep
    cfg = _small_cfg()
    scn = sweep.random_scenarios(cfg, 8, seed=3, use_native=False,
                                 device=dev)
    ref = sweep.run_batch(cfg, scn, 1)
    res, stats = sweep.run_sharded(cfg, scn, 1, devices=["cuda:0"] * 2)
    assert res.final_com.shape == (8, 3) and res.final_com.is_cuda
    assert float((res.final_com - ref.final_com).abs().max()) <= 0.05
    assert int(res.fell.sum()) == int(ref.fell.sum())
    torch.testing.assert_close(stats["goal_dist"], res.goal_dist.mean())


# ---------------------------------------------------------------------------
# the closed loop's tick replayed as a captured CUDA graph (runtime/graph.py)
# against the eager tick (loop._scan_ticks_eager), bit for bit
# ---------------------------------------------------------------------------

GRAPH_B = 16


def _ticks():
    """The cached graphs of graph.scan (the ticks)."""
    from apf_quadruped_tpu_torch.runtime import graph
    return [e for e in graph.entries() if e.k is not None]


def _calls():
    """The cached graphs of graph.call (plans, cycle heads)."""
    from apf_quadruped_tpu_torch.runtime import graph
    return [e for e in graph.entries() if e.k is None]


def _short_cycles(cfg, **gait):
    """cfg with 20-tick cycles (depth cut for time; the tick is the CLI's)."""
    import dataclasses
    return cfg.replace(gait=dataclasses.replace(
        cfg.gait, trot_cycle=0.05, crawl_cycle=0.05, **gait))


def _eager(fn, *args):
    """fn(*args) with the cycle's ticks, and each tick's WBC solve, run
    eagerly on the card."""
    from apf_quadruped_tpu_torch import wbc
    from apf_quadruped_tpu_torch.ops import qpsolve
    from apf_quadruped_tpu_torch.runtime import loop
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(loop, "_scan_ticks", loop._scan_ticks_eager)
        mp.setattr(wbc, "solve", wbc._solve_eager)
        mp.setattr(qpsolve, "solve_qp", qpsolve._solve_qp_eager)
        return fn(*args)


def _assert_bitwise(a, b):
    la, lb = _leaves(a), _leaves(b)
    assert len(la) == len(lb)
    for i, (x, y) in enumerate(zip(la, lb)):
        assert x.dtype == y.dtype and torch.equal(x, y), i


def _graph_case(case, dev, seed=0):
    """(cfg, terrain, targets, disturbances) of one bit-for-bit case."""
    from apf_quadruped_tpu_torch.runtime import sweep
    from apf_quadruped_tpu_torch.sim import terrain
    mode = case if case in ("crawl", "adaptive") else "trot"
    cfg = _short_cycles(sweep.cli_config(gait=mode),
                        early_td=case != "trot")
    scn = sweep.random_scenarios(cfg, GRAPH_B, seed=seed, use_native=False,
                                 device=dev)
    terr = (terrain.block(cfg.sim, batch=(GRAPH_B,), device=dev)
            if case == "height" else sweep._terrain(cfg, scn))
    return cfg, terr, scn.target_xy, scn.dist_sched


def _two_cycles(cfg, terr, tgt, dist, dev):
    from apf_quadruped_tpu_torch.runtime import loop
    return loop.run(cfg, loop.init(cfg, GRAPH_B, device=dev), terr, tgt,
                    dist, 2)


@pytest.mark.parametrize("case", ["trot", "height", "early_td", "crawl",
                                  "adaptive"])
def test_graphed_tick_equals_eager(dev, case):
    """Two cycles with the ticks replayed from the graph against the same
    two cycles run eagerly: every LoopState leaf and CycleMetrics field
    bit for bit.  trot: flat ground, early_td off; height: a height world
    (cone_rot in the tick); early_td: flat ground with it; crawl and
    adaptive: their gaits."""
    from apf_quadruped_tpu_torch.runtime import graph
    args = _graph_case(case, dev) + (dev,)
    graph.clear()
    graphed = _two_cycles(*args)
    assert len(_ticks()) == 1 and len(_calls()) == 2   # tick; head, tail
    _assert_bitwise(graphed, _eager(_two_cycles, *args))


def test_flat_and_height_sweeps_capture_graphs_apart(dev):
    """A flat batch and a batch on per-lane height maps in one process:
    each captures its own head, tick and tail, the flat batch's replays
    give what they gave before the height batch's capture bit for bit, and
    its tick graph launches the kernels it launched alone; the height
    batch's ground_feet is a share, the flat one's None."""
    from apf_quadruped_tpu_torch.runtime import graph, sweep
    cfg = _short_cycles(sweep.cli_config(), early_td=True)
    flat = sweep.random_scenarios(cfg, GRAPH_B, seed=3, use_native=False,
                                  device=dev)
    hilly = sweep.random_scenarios(
        cfg, GRAPH_B, seed=3, use_native=False, device=dev,
        worlds=["slope", "stairs"], spawn_x=(-0.3, 0.3),
        spawn_y=(0.85, 0.95))
    graph.clear()
    first = sweep.step_batch(cfg, flat, sweep.init_batch(cfg, flat), 2)
    flat_graphs = list(graph.entries())
    assert len(_ticks()) == 1
    ticks = _ticks()[0].launches
    hill = sweep.step_batch(cfg, hilly, sweep.init_batch(cfg, hilly), 2)
    assert len(graph.entries()) == 2 * len(flat_graphs)
    assert len(_ticks()) == 2 and _ticks()[0].launches == ticks
    again = sweep.step_batch(cfg, flat, sweep.init_batch(cfg, flat), 2)
    assert len(graph.entries()) == 2 * len(flat_graphs)
    _assert_bitwise(first, again)
    _assert_bitwise(hill, _eager(
        lambda: sweep.step_batch(cfg, hilly, sweep.init_batch(cfg, hilly),
                                 2)))
    assert first[1].ground_feet is None
    g = hill[1].ground_feet
    assert bool(((g >= 0) & (g <= 1)).all()) and bool(g.any())
    graph.clear()


def test_graph_reused_for_other_scenarios(dev):
    """A second batch of other scenarios of the same shape replays the
    cached graph (no capture) and equals its eager run bit for bit; the
    first batch's results, cloned out of the buffers, are left as they
    were."""
    from apf_quadruped_tpu_torch.runtime import graph
    graph.clear()
    first = _two_cycles(*_graph_case("early_td", dev, seed=0), dev)
    kept = [t.clone() for t in _leaves(first)]
    cached = {id(e) for e in graph.entries()}
    assert len(_ticks()) == 1 and len(cached) == 3     # tick, head, tail
    args = _graph_case("early_td", dev, seed=1) + (dev,)
    second = _two_cycles(*args)
    assert {id(e) for e in graph.entries()} == cached
    _assert_bitwise(second, _eager(_two_cycles, *args))
    _assert_bitwise(first, kept)
    assert not all(torch.equal(a, b) for a, b in zip(_leaves(first),
                                                     _leaves(second)))


def test_graphed_shards_on_one_card(dev):
    """step_batch_sharded over ["cuda:0", "cuda:0"]: the second shard
    replays the first shard's graph; both equal their eager runs bit for
    bit, and the gathered result agrees with run_batch within
    tests/test_sweep.py's gate."""
    from apf_quadruped_tpu_torch.parallel import mesh as mesh_mod
    from apf_quadruped_tpu_torch.runtime import graph, sweep
    cfg = _short_cycles(sweep.cli_config())
    scn = sweep.random_scenarios(cfg, GRAPH_B, seed=2, use_native=False,
                                 device=dev)
    m = mesh_mod.scenario_mesh(["cuda:0", "cuda:0"])

    def sharded():
        return sweep.step_batch_sharded(
            cfg, mesh_mod.shard_batch(m, scn),
            mesh_mod.shard_batch(m, sweep.init_batch(cfg, scn)), 2, m)

    graph.clear()
    graphed = sharded()
    assert len(_ticks()) == 1 and len(_calls()) == 2   # tick; head, tail
    _assert_bitwise(graphed, _eager(sharded))
    ref = sweep.step_batch(cfg, scn, sweep.init_batch(cfg, scn), 2)
    com = mesh_mod.gather(m, graphed[1]).com
    assert float((com - ref[1].com).abs().max()) <= 0.05


def test_graph_capture_failure_raises(dev):
    """A step that reads a value back to the host cannot be captured: the
    capture raises and nothing runs the step eagerly instead; the failed
    capture's memory pool is closed, so later captures free their memory."""
    from apf_quadruped_tpu_torch.runtime import graph

    def step(inputs, carry, k, outs):
        (x,) = carry
        return (x + 1.0 if bool(x.sum() > 0) else x - 1.0,)

    cached = graph.entries()
    with pytest.raises(RuntimeError):
        graph.scan(("host read",), step, (), (torch.ones(4, device=dev),),
                   (), 3)
    torch.cuda.synchronize()
    assert graph.entries() == cached
    # the failed capture's pool is closed: a later capture's memory goes
    # back to the card when its graph is dropped
    x = torch.ones(2**26, device=dev)
    torch.cuda.empty_cache()
    before = torch.cuda.memory_reserved()
    y = graph.call(("after a failed capture",), lambda a: a[0] * 2.0, (x,))
    assert torch.equal(y, x * 2.0)
    del y
    graph.clear()
    torch.cuda.empty_cache()
    # x is 256 MiB; a capture routed into the dead pool would keep its
    # buffers (3 x 256 MiB) reserved
    assert torch.cuda.memory_reserved() - before < 2**26


def test_spd_route_above_kernel_size_launches_nothing(rng, dev):
    """n > 64 (the condensed planner's n = 12H) is routed by shape to
    cholesky_ex and the triangular solves, before any launch."""
    H = _spd(rng, 3, 240, dev)
    r = torch.as_tensor(rng.normal(size=(3, 240, 2)), dtype=torch.float32,
                        device=dev)
    before = (cuda_chol.chol_factor.launches, cuda_chol.chol_sub.launches)
    L, d = chol.spd_factor(H)
    X = chol.spd_solve((L, d), r)
    assert (cuda_chol.chol_factor.launches,
            cuda_chol.chol_sub.launches) == before
    Lp, dp = chol.plain_factor(H)
    assert torch.equal(L, Lp) and torch.equal(d, dp)
    assert torch.equal(X, chol.plain_solve(Lp, dp, r))


# ---------------------------------------------------------------------------
# chol_solve (csrc/spd_chol.cu spd_solve_kernel) and the scan's use_pallas
# ---------------------------------------------------------------------------

# chol_solve compiles to widths 12, 18 and 30 (n <= 12, 13..18, 19..30,
# padded with an identity block as staged); 31 <= n <= 64 takes the wide
# body.  k < 8 runs lanes over rows, k >= 8 lanes over the right-hand
# sides, 32 at a time.  The sizes sit on each edge; the batches around the
# use_pallas scan's 256 and past 2048.
@pytest.mark.parametrize("n", [1, 5, 11, 12, 13, 18, 19, 30, 31, 64])
@pytest.mark.parametrize("B", [1, 64, 257, 2049])
@pytest.mark.parametrize("k", [1, 7, 8, 13, 33])
def test_chol_solve_kernel_matches_plain(rng, dev, n, B, k):
    M = _spd(rng, B, n, dev)
    r = torch.as_tensor(rng.normal(size=(B, n, k)), dtype=torch.float32,
                        device=dev)
    before = cuda_chol.chol_solve.launches
    X = chol.chol_solve(M, r)
    assert cuda_chol.chol_solve.launches == before + 1
    assert _rel(X, chol.plain_chol_solve(M, r)) <= 1e-5


@pytest.mark.parametrize("n", [5, 12, 13, 30, 64])
@pytest.mark.parametrize("k", [1, 13])
def test_chol_solve_kernel_nan_lane(rng, dev, n, k):
    """A matrix that is not positive definite, and one with a NaN below
    the diagonal, give all-NaN X, as the plain version's; every other lane
    is bit for bit what it is in a batch without them."""
    M = _spd(rng, 5, n, dev)
    r = torch.as_tensor(rng.normal(size=(5, n, k)), dtype=torch.float32,
                        device=dev)
    X0 = cuda_chol.chol_solve(M, r)
    bad = M.clone()
    bad[3, n - 1, n - 1] = -2.0
    bad[1, n - 1, 0] = bad[1, 0, n - 1] = float("nan")
    X = cuda_chol.chol_solve(bad, r)
    Xp = chol.plain_chol_solve(bad, r)
    for lane in (1, 3):
        assert bool(X[lane].isnan().all() & Xp[lane].isnan().all())
    assert torch.equal(X[[0, 2, 4]], X0[[0, 2, 4]])


@pytest.mark.parametrize("n", [12, 18, 30])
@pytest.mark.parametrize("k", [1, 13])
def test_chol_solve_kernel_unaligned_buffers(rng, dev, n, k):
    """M and rhs that do not start on a 16-byte boundary (contiguous views
    one float into their storage): M is staged row by row instead of with
    16-byte copies, with the same answer bit for bit."""
    M = _spd(rng, 5, n, dev)
    r = torch.as_tensor(rng.normal(size=(5, n, k)), dtype=torch.float32,
                        device=dev)
    X = cuda_chol.chol_solve(M, r)

    def shifted(t):
        s = torch.empty(t.numel() + 1, device=dev)
        s[1:] = t.reshape(-1)
        return s[1:].view(t.shape)
    Mu, ru = shifted(M), shifted(r)
    assert Mu.data_ptr() % 16 != 0 and Mu.is_contiguous()
    assert torch.equal(cuda_chol.chol_solve(Mu, ru), X)


def test_use_pallas_scan_on_the_card(rng, dev):
    """The scan IPM with use_pallas launches chol_solve once per knot per
    pass and agrees with the default path on the card."""
    import dataclasses
    qp = _qp(rng, dev, NX=13, NU=12, M=24, H=6)
    cfg_p = dataclasses.replace(CFG, use_pallas=True)
    before = cuda_chol.chol_solve.launches
    out = tr.solve_stage_qp(qp, cfg_p)
    assert cuda_chol.chol_solve.launches > before
    _assert_close(out, tr.solve_stage_qp(qp, CFG), atol=2e-4)


# ---------------------------------------------------------------------------
# the fused Riccati passes (csrc/fused_riccati.cu) and the fused IPM
# ---------------------------------------------------------------------------

def _pass_data(rng, dev, B, H=20, nx=13, nu=12, m=24, mask_frac=0.8):
    d = problems.random_stage_qp(rng, B=B, H=H, NX=nx, NU=nu, M=m,
                                 mask_frac=mask_frac, diag_q=False)
    t = {k: torch.as_tensor(v, device=dev) for k, v in d.items()}
    f32 = dict(dtype=torch.float32, device=dev)
    mask = t["mask"]
    t.update(u=torch.as_tensor(rng.normal(size=(B, H, nu)), **f32),
             zm=mask * torch.as_tensor(rng.uniform(0.1, 2, (B, H, m)), **f32),
             W=mask * torch.as_tensor(rng.uniform(0.1, 10, (B, H, m)), **f32),
             rx=torch.as_tensor(rng.normal(size=(B, H, nu)), **f32),
             vm=mask * torch.as_tensor(rng.normal(size=(B, H, m)), **f32),
             Rreg=t["R"] + 1e-6 * torch.eye(nu, **f32))
    return t


@pytest.mark.parametrize("B", [4, 130, 2048])
@pytest.mark.parametrize("mask_frac", [1.0, 0.6])
def test_fused_passes_match_plain(rng, dev, B, mask_frac):
    """Each pass against its plain version on the same inputs on the card:
    rollout and vector at 1e-5 relative to the largest entry, the factor's
    L, dinv and K too (float32 roundings of 13-term sums)."""
    d = _pass_data(rng, dev, B, mask_frac=mask_frac)
    from apf_quadruped_tpu_torch.ops import cuda_riccati as cr
    args = (d["G"], d["R"], d["Q"], d["A"], d["B"], d["qlin"], d["u"],
            d["zm"], d["x0"])
    n0 = (cr.fused_rollout.launches, cr.fused_factor.launches,
          cr.fused_vector.launches)
    for a, b in zip(cr.fused_rollout(*args), cr.plain_rollout(*args)):
        assert _rel(a, b) <= 1e-5
    fargs = (d["G"], d["Rreg"], d["Q"], d["A"], d["B"], d["W"])
    F = cr.fused_factor(*fargs)
    for a, b in zip(F, cr.plain_factor_pass(*fargs)):
        assert _rel(a, b) <= 1e-5
    assert bool((torch.triu(F[0], 1) == 0).all())
    vargs = (d["G"], d["A"], d["B"], *F, d["rx"], d["vm"])
    for a, b in zip(cr.fused_vector(*vargs), cr.plain_vector_pass(*vargs)):
        assert _rel(a, b) <= 1e-5
    assert (cr.fused_rollout.launches, cr.fused_factor.launches,
            cr.fused_vector.launches) == tuple(n + 1 for n in n0)


def _factor_vector_against_plain(d):
    """fused_factor and fused_vector (on the kernel's own factors) against
    their plain versions, 1e-5 relative to the largest entry; L's exact
    zeros above the diagonal."""
    from apf_quadruped_tpu_torch.ops import cuda_riccati as cr
    fargs = (d["G"], d["Rreg"], d["Q"], d["A"], d["B"], d["W"])
    F = cr.fused_factor(*fargs)
    for a, b in zip(F, cr.plain_factor_pass(*fargs)):
        assert _rel(a, b) <= 1e-5
    assert bool((torch.triu(F[0], 1) == 0).all())
    vargs = (d["G"], d["A"], d["B"], *F, d["rx"], d["vm"])
    for a, b in zip(cr.fused_vector(*vargs), cr.plain_vector_pass(*vargs)):
        assert _rel(a, b) <= 1e-5


# The factor and vector kernels stage knot k -+ 1 into a two-slot ring
# while they work on knot k: one knot, two (each slot once) and a long
# horizon (the vector pass's kff for all 30 knots in shared memory).
@pytest.mark.parametrize("H", [1, 2, 30])
def test_fused_factor_vector_ring_over_horizons(rng, dev, H):
    _factor_vector_against_plain(_pass_data(rng, dev, 9, H=H))


@pytest.mark.parametrize("B", [1, 2049])
def test_fused_factor_vector_batch_off_the_block(rng, dev, B):
    _factor_vector_against_plain(_pass_data(rng, dev, B, H=5))


# Compile-time widths 13 / 12 and 24 or 32 rows: smaller problems are
# padded as the knot is staged (zeros, R's identity block); m > 24 runs
# the 32-row instance.
@pytest.mark.parametrize("nx,nu,m", [(1, 1, 1), (6, 4, 8), (13, 12, 5),
                                     (13, 12, 25), (13, 12, 32)])
def test_fused_factor_vector_padded_widths(rng, dev, nx, nu, m):
    _factor_vector_against_plain(_pass_data(rng, dev, 6, H=4, nx=nx, nu=nu,
                                            m=m))


def _rollout_against_plain(d):
    """fused_rollout against its plain version, 1e-5 relative to the
    largest entry of each output."""
    from apf_quadruped_tpu_torch.ops import cuda_riccati as cr
    args = (d["G"], d["R"], d["Q"], d["A"], d["B"], d["qlin"], d["u"],
            d["zm"], d["x0"])
    for a, b in zip(cr.fused_rollout(*args), cr.plain_rollout(*args)):
        assert _rel(a, b) <= 1e-5


# The rollout stages knot k -+ 1 into a two-slot ring while it works on
# knot k and keeps each knot's costate bracket on chip for the backward
# sweep: one knot, two, a long horizon and the longest it takes.
@pytest.mark.parametrize("H", [1, 2, 30, "H_MAX"])
def test_fused_rollout_ring_over_horizons(rng, dev, H):
    from apf_quadruped_tpu_torch import _kernels
    H = _kernels.fused_riccati_limits()[3] if H == "H_MAX" else H
    _rollout_against_plain(_pass_data(rng, dev, 9, H=H))


@pytest.mark.parametrize("B", [1, 2049])
def test_fused_rollout_batch_off_the_block(rng, dev, B):
    _rollout_against_plain(_pass_data(rng, dev, B, H=5))


# Compile-time widths 13 / 12 and 24 or 32 rows, smaller problems padded
# as each knot is staged.
@pytest.mark.parametrize("nx,nu,m", [(1, 1, 1), (6, 4, 8), (13, 12, 5),
                                     (13, 12, 25), (13, 12, 32)])
def test_fused_rollout_padded_widths(rng, dev, nx, nu, m):
    _rollout_against_plain(_pass_data(rng, dev, 6, H=4, nx=nx, nu=nu, m=m))


@pytest.mark.parametrize("k_bad", [0, 3, 6])
def test_fused_rollout_nan_knot(rng, dev, k_bad):
    """A NaN in one knot's A gives the plain version's NaN pattern in x, rx
    and gu, the finite entries within 1e-5 of it; other lanes finite."""
    from apf_quadruped_tpu_torch.ops import cuda_riccati as cr
    d = _pass_data(rng, dev, 5, H=7)
    d["A"][2, k_bad, 3, 5] = float("nan")
    args = (d["G"], d["R"], d["Q"], d["A"], d["B"], d["qlin"], d["u"],
            d["zm"], d["x0"])
    for a, b in zip(cr.fused_rollout(*args), cr.plain_rollout(*args)):
        assert torch.equal(a.isnan(), b.isnan())
        ok = ~b.isnan()
        assert float((a[ok] - b[ok]).abs().max()) <= 1e-5 * float(
            b[ok].abs().max())
        assert bool(a[[0, 1, 3, 4]].isfinite().all())
    assert bool(cr.fused_rollout(*args)[0][2, k_bad:].isnan().any())


@pytest.mark.parametrize("k_bad", [0, 3, 6])
def test_fused_factor_nan_knot(rng, dev, k_bad):
    """A knot whose M is not positive definite: its L, dinv and K and those
    of every earlier knot are NaN; later knots match the plain version;
    other lanes are untouched."""
    from apf_quadruped_tpu_torch.ops import cuda_riccati as cr
    d = _pass_data(rng, dev, 5, H=7)
    d["W"][2, k_bad] = -1e3
    fargs = (d["G"], d["Rreg"], d["Q"], d["A"], d["B"], d["W"])
    F = cr.fused_factor(*fargs)
    P = cr.plain_factor_pass(*fargs)
    # the plain version's factor of knot k_bad is all NaN (cholesky_ex's
    # info); earlier knots factor a NaN matrix, whose factor on the card
    # may keep zeros above the diagonal
    low = torch.ones(12, 12, dtype=torch.bool, device=dev).tril()
    for n, (a, b) in enumerate(zip(F, P)):
        assert bool(a[2, :k_bad + 1].isnan().all())
        ref = b[2, :k_bad + 1]
        assert bool((ref[..., low] if n == 0 else ref).isnan().all())
        if k_bad + 1 < 7:
            assert _rel(a[2, k_bad + 1:], b[2, k_bad + 1:]) <= 1e-5
        assert _rel(a[[0, 1, 3, 4]], b[[0, 1, 3, 4]]) <= 1e-5


def test_fused_vector_on_plain_factors(rng, dev):
    """The vector pass on L, dinv, K from the plain factor pass gives the
    plain vector pass's du and gdu."""
    from apf_quadruped_tpu_torch.ops import cuda_riccati as cr
    d = _pass_data(rng, dev, 130, H=20)
    F = cr.plain_factor_pass(d["G"], d["Rreg"], d["Q"], d["A"], d["B"],
                             d["W"])
    vargs = (d["G"], d["A"], d["B"], *F, d["rx"], d["vm"])
    for a, b in zip(cr.fused_vector(*vargs), cr.plain_vector_pass(*vargs)):
        assert _rel(a, b) <= 1e-5


@pytest.mark.parametrize("kw,atol", [({}, ATOL),
                                     (dict(B=130, H=3, NX=4, NU=3, M=4), 1e-4),
                                     (dict(mask_frac=0.0), ATOL)])
def test_fused_ipm_matches_scan(rng, dev, kw, atol):
    from apf_quadruped_tpu_torch.ops import cuda_riccati as cr
    qp = _qp(rng, dev, **kw)
    before = cr.fused_factor.launches
    out = cr.solve_stage_qp_fused(qp, CFG)
    assert cr.fused_factor.launches == before + CFG.iters
    _assert_close(out, tr.solve_stage_qp(qp, CFG), atol=atol)


def test_fused_ipm_nan_lane(rng, dev):
    from apf_quadruped_tpu_torch.ops import cuda_riccati as cr
    qp = _qp(rng, dev)
    x0 = qp.x0.clone()
    x0[1, 0] = float("nan")
    out = cr.solve_stage_qp_fused(qp._replace(x0=x0), CFG)
    assert bool(torch.isfinite(out.u).all())
    assert not bool(out.converged[1]) and bool((out.u[1] == 0).all())
    _assert_close(out, tr.solve_stage_qp(qp._replace(x0=x0), CFG))


def test_fused_plan_and_reroute(dev):
    """plan(backend="riccati_fused") on the card runs the three kernels and
    agrees with the resident plan; with base_box it runs the resident
    kernel instead."""
    from apf_quadruped_tpu_torch.ops import cuda_riccati as cr
    cfg = EngineConfig(mpc=MpcConfig(horizon=20, dt=0.025,
                                     backend="riccati_fused"),
                       solver=SolverConfig())
    x0, refs = problems.bench_problem(cfg, 8, device=dev)
    n0 = (cr.fused_rollout.launches, cr.fused_vector.launches)
    out = planner.plan(cfg, x0, refs)
    assert (cr.fused_rollout.launches - n0[0],
            cr.fused_vector.launches - n0[1]) == (SolverConfig().iters + 1,
                                                  2 * SolverConfig().iters)
    res = planner.plan(EngineConfig(mpc=MpcConfig(horizon=20, dt=0.025),
                                    solver=SolverConfig()), x0, refs)
    assert torch.equal(out.sol.iters, res.sol.iters)
    ftol = 1e-3 * max(1.0, float(res.forces.abs().max()))
    assert float((out.forces - res.forces).abs().max()) <= ftol
    boxed = EngineConfig(mpc=MpcConfig(horizon=20, dt=0.025, base_box=True,
                                       backend="riccati_fused"))
    r0, f0 = (cuda_riccati.solve_stage_qp_resident.launches,
              cr.fused_factor.launches)
    planner.plan(boxed, x0, refs)
    assert cuda_riccati.solve_stage_qp_resident.launches == r0 + 1
    assert cr.fused_factor.launches == f0


def test_condensed_plan_on_the_card(dev):
    """The condensed backend (n = 240, plain Cholesky by the shape rule)
    against the resident plan, at the tighter tolerance its cross-check
    needs: states within 5e-3, per-knot force sums within 5 N."""
    sol = SolverConfig(iters=40, reltol=1e-6, abstol=1e-5)
    cfg = EngineConfig(mpc=MpcConfig(horizon=20, dt=0.025,
                                     backend="condensed"), solver=sol)
    x0, refs = problems.bench_problem(cfg, 16, device=dev)
    out = planner.plan(cfg, x0, refs)
    res = planner.plan(EngineConfig(mpc=MpcConfig(horizon=20, dt=0.025),
                                    solver=sol), x0, refs)
    assert bool(out.sol.converged.all() & res.sol.converged.all())
    assert float((out.states - res.states).abs().max()) <= 5e-3
    assert float((out.forces.sum(-2) - res.forces.sum(-2)).abs().max()) <= 5.0


# ---------------------------------------------------------------------------
# SolverConfig.stage_bf16: the bf16 instances of the resident IPM and the
# fused passes against their plain versions on the rounded inputs
# ---------------------------------------------------------------------------

CFG16 = SolverConfig(iters=15, reltol=1e-4, abstol=1e-4, static_reg=1e-6,
                     w_clip=1e6, stage_bf16=True)


def _bf16_against_plain(qp, warm=None, atol=ATOL):
    """The resident kernel with stage_bf16 against the scan on A and B
    rounded to bfloat16; one launch."""
    before = cuda_riccati.solve_stage_qp_resident.launches
    out = cuda_riccati.solve_stage_qp_resident(qp, CFG16, warm)
    assert cuda_riccati.solve_stage_qp_resident.launches == before + 1
    ref = tr.solve_stage_qp(tr.round_stage_bf16(qp), CFG, warm)
    assert out.z.shape == ref.z.shape
    _assert_close(out, ref, atol)
    return out


@pytest.mark.parametrize("has_warm,mc,acc", VARIANTS)
def test_bf16_kernel_matches_plain(rng, dev, has_warm, mc, acc):
    qp = _qp(rng, dev, mc=mc, acc=acc)
    warm = None
    if has_warm:
        cold = tr.solve_stage_qp(tr.round_stage_bf16(qp), CFG)
        warm = tr.WarmStart(u=cold.u, z=cold.z, s=cold.s,
                            valid=torch.tensor([True, False, True, True],
                                               device=dev))
    out = _bf16_against_plain(qp, warm)
    # the rounding is applied: the float32 kernel's answer is elsewhere
    f32 = cuda_riccati.solve_stage_qp_resident(qp, CFG, warm)
    assert float((out.u - f32.u).abs().max()) > 1e-3


@pytest.mark.parametrize("H", [1, 2, 7, 30, 40])
def test_bf16_kernel_ring_over_horizons(rng, dev, H):
    """The widen of each knot's bf16 block on one knot, two, an odd
    horizon and long ones, with state rows and accel rows."""
    _bf16_against_plain(_qp(rng, dev, mc=6, acc=True, H=H, a_noise=0.03))


@pytest.mark.parametrize("B", [1, 130, 2049])
def test_bf16_kernel_batch_off_the_block(rng, dev, B):
    """As test_kernel_batch_off_the_block: the lanes repeat 9 problems, and
    every copy of a problem comes back equal bit for bit."""
    q = problems.random_stage_qp(rng, B=min(B, 9), H=5, NX=13, NU=12, M=24,
                                 mc=6, acc=True)
    lanes = np.arange(B) % 9 if B > 9 else np.arange(B)
    q = {k: v[lanes] if k in ("A", "B", "qlin", "mask", "x0", "cx", "mask_x")
         else v for k, v in q.items()}
    out = _bf16_against_plain(convert.stage_qp(q, dev))
    first = torch.as_tensor(lanes, device=dev)
    for f in ("u", "x", "z", "s", "zx", "sx", "iters"):
        assert torch.equal(getattr(out, f), getattr(out, f)[first]), f


def test_bf16_kernel_nan_lane_quarantined(rng, dev):
    qp = _qp(rng, dev)
    x0 = qp.x0.clone()
    x0[1, 0] = float("nan")
    out = _bf16_against_plain(qp._replace(x0=x0))
    assert bool(torch.isfinite(out.u).all() & torch.isfinite(out.z).all())
    assert bool((out.u[1] == 0).all()) and not bool(out.converged[1])


def test_bf16_kernel_masked_rows_inert(rng, dev):
    qp = _qp(rng, dev, mask_frac=0.5)
    mask = qp.mask.clone()
    mask[..., 0] = 0.0
    qp = qp._replace(mask=mask)
    base = cuda_riccati.solve_stage_qp_resident(qp, CFG16)
    G, h = qp.G.clone(), qp.h.clone()
    G[0] *= -3.0
    h[0] = 0.01
    _assert_equal(cuda_riccati.solve_stage_qp_resident(
        qp._replace(G=G, h=h), CFG16), base)


@pytest.mark.parametrize("mc,acc", [(0, False), (6, True)])
def test_bf16_kernel_invalid_warm_start_equals_cold(rng, dev, mc, acc):
    qp = _qp(rng, dev, mc=mc, acc=acc)
    cold = cuda_riccati.solve_stage_qp_resident(qp, CFG16)
    B, H, nu = qp.B.shape[0], qp.B.shape[1], qp.B.shape[-1]
    mt = cold.z.shape[-1]
    off = tr.WarmStart(u=torch.full((B, H, nu), 3.0, device=dev),
                       z=torch.full((B, H, mt), 5.0, device=dev),
                       s=torch.full((B, H, mt), 7.0, device=dev),
                       valid=torch.zeros(B, dtype=torch.bool, device=dev))
    _assert_equal(cuda_riccati.solve_stage_qp_resident(qp, CFG16, off), cold)


def test_bf16_kernel_reads_bf16_buffers(rng, dev, monkeypatch):
    """The launch gets A and B' in bfloat16 blocks and knot records without
    them: nothing widens A and B before the kernel."""
    seen = []
    pack = cuda_riccati._pack

    def spy(*args):
        seen.append(pack(*args))
        return seen[-1]
    monkeypatch.setattr(cuda_riccati, "_pack", spy)
    _bf16_against_plain(_qp(rng, dev, mc=6, acc=True))
    from apf_quadruped_tpu_torch import _kernels
    lay = _kernels.resident_ipm_layout()
    (got,) = seen
    assert got["ab"].dtype == torch.bfloat16
    assert got["ab"].shape[-1] == lay["AB_REC"]
    assert got["knots"].shape[-1] == lay["IN_REC"] - lay["AB_IN0"]
    assert all(v.dtype == torch.float32 for k, v in got.items() if k != "ab")


def _bf16_passes_against_plain(d, A16=None, B16=None):
    """The three fused passes with bfloat16 A and Bm (A16, B16, by default
    d's rounded) against their plain versions on the same inputs, 1e-5
    relative to the largest entry, and the float32 passes on the rounded
    A and B the same way; one launch of each bf16 kernel."""
    from apf_quadruped_tpu_torch.ops import cuda_riccati as cr
    A16 = d["A"].to(torch.bfloat16) if A16 is None else A16
    B16 = d["B"].to(torch.bfloat16) if B16 is None else B16
    n0 = (cr.fused_rollout.launches, cr.fused_factor.launches,
          cr.fused_vector.launches)
    roll = (d["G"], d["R"], d["Q"], A16, B16, d["qlin"], d["u"], d["zm"],
            d["x0"])
    for a, b in zip(cr.fused_rollout(*roll), cr.plain_rollout(*roll)):
        assert _rel(a, b) <= 1e-5
    fargs = (d["G"], d["Rreg"], d["Q"], A16, B16, d["W"])
    F = cr.fused_factor(*fargs)
    for a, b in zip(F, cr.plain_factor_pass(*fargs)):
        assert _rel(a, b) <= 1e-5
    assert bool((torch.triu(F[0], 1) == 0).all())
    vargs = (d["G"], A16, B16, *F, d["rx"], d["vm"])
    for a, b in zip(cr.fused_vector(*vargs), cr.plain_vector_pass(*vargs)):
        assert _rel(a, b) <= 1e-5
    assert (cr.fused_rollout.launches, cr.fused_factor.launches,
            cr.fused_vector.launches) == tuple(n + 1 for n in n0)
    # the float32 kernels on the rounded A and B: the same function
    Ar, Br = A16.float(), B16.float()
    F32 = cr.fused_factor(d["G"], d["Rreg"], d["Q"], Ar, Br, d["W"])
    for a, b in zip(F, F32):
        assert _rel(a, b) <= 1e-5


@pytest.mark.parametrize("B,H", [(4, 1), (4, 2), (130, 3), (130, 30),
                                 (2048, 20), (9, "H_MAX")])
@pytest.mark.parametrize("mask_frac", [1.0, 0.6])
def test_bf16_passes_match_plain(rng, dev, B, H, mask_frac):
    """Odd horizons put every other knot's unpadded A_k on a 2-byte
    boundary: the padded layout keeps each on 16 bytes."""
    from apf_quadruped_tpu_torch import _kernels
    H = _kernels.fused_riccati_limits()[3] if H == "H_MAX" else H
    _bf16_passes_against_plain(_pass_data(rng, dev, B, H=H,
                                          mask_frac=mask_frac))


@pytest.mark.parametrize("nx,nu,m", [(1, 1, 1), (6, 4, 8), (13, 12, 5),
                                     (13, 12, 25), (13, 12, 32)])
def test_bf16_passes_padded_widths(rng, dev, nx, nu, m):
    _bf16_passes_against_plain(_pass_data(rng, dev, 6, H=5, nx=nx, nu=nu,
                                          m=m))


@pytest.mark.parametrize("offset", [8, 3])
def test_bf16_passes_at_an_offset(rng, dev, offset):
    """A and B as views into larger bf16 buffers, `offset` elements in: 8
    keeps the kernels' layout (16 bytes), which they read in place; 3 does
    not, and the wrappers copy into it."""
    from apf_quadruped_tpu_torch.ops import cuda_riccati as cr
    d = _pass_data(rng, dev, 130, H=7)

    def inside(M):
        nb, H, r, c = M.shape
        p = -(-r * c // 8) * 8
        buf = torch.zeros(offset + nb * H * p, dtype=torch.bfloat16,
                          device=dev)
        view = buf[offset:].view(nb, H, p)[..., :r * c].unflatten(-1, (r, c))
        view.copy_(M)
        assert cr._in_bf16_layout(view) == (offset % 8 == 0)
        return view
    _bf16_passes_against_plain(d, inside(d["A"]), inside(d["B"]))


def test_bf16_passes_reject_mixed_storage(rng, dev):
    from apf_quadruped_tpu_torch.ops import cuda_riccati as cr
    d = _pass_data(rng, dev, 4, H=3)
    with pytest.raises(TypeError, match="bfloat16"):
        cr.fused_factor(d["G"], d["Rreg"], d["Q"], d["A"].to(torch.bfloat16),
                        d["B"], d["W"])


@pytest.mark.parametrize("kw,atol", [({}, ATOL),
                                     (dict(B=130, H=3, NX=4, NU=3, M=4), 1e-4)])
def test_bf16_fused_ipm_matches_scan(rng, dev, kw, atol):
    from apf_quadruped_tpu_torch.ops import cuda_riccati as cr
    qp = _qp(rng, dev, **kw)
    before = cr.fused_factor.launches
    out = cr.solve_stage_qp_fused(qp, CFG16)
    assert cr.fused_factor.launches == before + CFG.iters
    _assert_close(out, tr.solve_stage_qp(tr.round_stage_bf16(qp), CFG),
                  atol=atol)


@pytest.mark.parametrize("backend", ["auto", "riccati_fused"])
def test_bf16_plan_runs_the_bf16_kernels(dev, backend):
    """plan with stage_bf16 through "auto" (the resident kernel) and
    "riccati_fused" on the card: the kernels launch, and the plan is the
    scan's on the rounded stage QP."""
    from apf_quadruped_tpu_torch.ops import cuda_riccati as cr
    cfg = EngineConfig(mpc=MpcConfig(horizon=20, dt=0.025, backend=backend),
                       solver=SolverConfig(stage_bf16=True))
    x0, refs = problems.bench_problem(cfg, 8, device=dev)
    n0 = (cuda_riccati.solve_stage_qp_resident.launches,
          cr.fused_factor.launches)
    out = planner.plan(cfg, x0, refs)
    n1 = (cuda_riccati.solve_stage_qp_resident.launches,
          cr.fused_factor.launches)
    assert n1[backend == "riccati_fused"] > n0[backend == "riccati_fused"]
    qp = tr.round_stage_bf16(planner.stage_qp(cfg, x0, refs))
    ref = tr.solve_stage_qp(qp, cfg.solver)
    assert torch.equal(out.sol.iters, ref.iters)
    ftol = 1e-3 * max(1.0, float(ref.u.abs().max()))
    assert float((out.forces.reshape(ref.u.shape) - ref.u).abs().max()) \
        <= ftol


# ---------------------------------------------------------------------------
# planner.plan and the cycle's head replayed from captured CUDA graphs
# (runtime/graph.call) against their eager bodies, bit for bit
# ---------------------------------------------------------------------------

# every backend and option of the plan: (backend, MpcConfig fields,
# SolverConfig fields, terrain-aligned cones)
PLAN_OPTIONS = {
    "resident": ("riccati_resident", {}, {}, False),
    "resident cone_rot": ("riccati_resident", {}, {}, True),
    "resident stage_bf16": ("riccati_resident", {}, dict(stage_bf16=True),
                            False),
    "fused": ("riccati_fused", {}, {}, False),
    "fused cone_rot": ("riccati_fused", {}, {}, True),
    "fused stage_bf16": ("riccati_fused", {}, dict(stage_bf16=True), False),
    "fused base_box+base_acc": ("riccati_fused",
                                dict(base_box=True, base_acc=True), {},
                                False),
    "scan": ("riccati", {}, {}, False),
    "use_pallas": ("riccati", {}, dict(use_pallas=True), False),
    "condensed": ("condensed", {}, {}, False),
    "condensed base_box+base_acc cone_rot": (
        "condensed", dict(base_box=True, base_acc=True), {}, True),
    "sqp_iters=2": ("riccati_resident", dict(sqp_iters=2), {}, False),
}


def _plan_cfg(option, H=20):
    backend, mpc, solver, _ = PLAN_OPTIONS[option]
    return EngineConfig(mpc=MpcConfig(horizon=H, dt=0.025, backend=backend,
                                      **mpc),
                        solver=SolverConfig(**solver))


def _plan_problem(option, cfg, B, dev, seed):
    """bench.py's problem, with terrain-aligned cones where the option
    asks for them."""
    x0, refs = problems.bench_problem(cfg, B, seed=seed, device=dev)
    if PLAN_OPTIONS[option][3]:
        from apf_quadruped_tpu_torch.sim import terrain
        gen = torch.Generator(dev).manual_seed(seed)
        n = torch.randn(B, cfg.mpc.horizon, 4, 3, device=dev,
                        generator=gen) * 0.2
        n[..., 2] = 1.0
        refs = refs._replace(cone_rot=terrain.basis_from_normal(
            n / torch.linalg.vector_norm(n, dim=-1, keepdim=True)))
    return x0, refs


def _warm_from(out, B, H):
    """A warm start from a plan, half its lanes valid."""
    return tr.WarmStart(u=out.forces.reshape(B, H, 12),
                        z=out.sol.z.reshape(B, H, -1),
                        s=out.sol.s.reshape(B, H, -1),
                        valid=torch.arange(B, device=out.forces.device) % 2
                        == 0)


@pytest.mark.parametrize("H", [20, 40])
@pytest.mark.parametrize("B", [1, 64, 2048])
@pytest.mark.parametrize("option", list(PLAN_OPTIONS))
def test_graphed_plan_equals_eager(dev, option, B, H):
    """plan on the card replays its graph: cold and warm (two graphs; one
    for the condensed backend, which takes no warm start), each bit for
    bit the eager body's, and a second problem through the same cached
    graphs bit for bit its eager plans."""
    from apf_quadruped_tpu_torch.runtime import graph
    cfg = _plan_cfg(option, H)
    graph.clear()
    # the eager plans first, so that the largest (the condensed QP at
    # B=2048, H=40: ~26 GB eager, a ~45 GB pool) need not fit side by side
    cases = []
    for seed in (0, 1):
        x0, refs = _plan_problem(option, cfg, B, dev, seed)
        cold = planner._plan_eager(cfg, x0, refs)
        warm = _warm_from(cold, B, H)
        cases.append((x0, refs, warm, cold,
                      planner._plan_eager(cfg, x0, refs, warm)))
    torch.cuda.empty_cache()
    for x0, refs, warm, cold, warmed in cases:
        _assert_bitwise(planner.plan(cfg, x0, refs), cold)
        _assert_bitwise(planner.plan(cfg, x0, refs, warm), warmed)
        # condensed: no warm start, one graph for both
        assert len(graph.entries()) == 2 - (cfg.mpc.backend == "condensed")
    graph.clear()


@pytest.mark.parametrize("option", ["resident", "fused", "scan",
                                    "use_pallas", "condensed"])
def test_graphed_plan_quarantines_a_nan_lane(dev, option):
    from apf_quadruped_tpu_torch.runtime import graph
    cfg = _plan_cfg(option)
    x0, refs = _plan_problem(option, cfg, 64, dev, 0)
    graph.clear()
    planner.plan(cfg, x0, refs)                    # capture on finite data
    x0 = x0.clone()
    x0[1, 0] = float("nan")
    out = planner.plan(cfg, x0, refs)
    assert len(graph.entries()) == 1
    assert bool(torch.isfinite(out.forces).all())
    assert not bool(out.sol.converged[1]) and bool((out.forces[1] == 0).all())
    # bit patterns: the condensed plan leaves the lane's states NaN
    for x, y in zip(_leaves(out), _leaves(planner._plan_eager(cfg, x0,
                                                              refs))):
        if x.is_floating_point():
            x, y = x.view(torch.int32), y.view(torch.int32)
        assert torch.equal(x, y)


@pytest.mark.parametrize("option", ["resident", "fused", "use_pallas",
                                    "resident stage_bf16"])
def test_graphed_plan_counts_one_plans_launches(dev, option):
    """The counters advance by an eager plan's launches at the capturing
    call and at each replay."""
    from apf_quadruped_tpu_torch.ops import cuda_chol
    from apf_quadruped_tpu_torch.runtime import graph
    counters = (cuda_riccati.solve_stage_qp_resident,
                cuda_riccati.fused_rollout, cuda_riccati.fused_factor,
                cuda_riccati.fused_vector, cuda_chol.chol_solve)

    def counts():
        return np.array([f.launches for f in counters])

    cfg = _plan_cfg(option)
    x0, refs = _plan_problem(option, cfg, 64, dev, 0)
    n0 = counts()
    planner._plan_eager(cfg, x0, refs)
    one = counts() - n0
    assert one.sum() > 0
    graph.clear()
    for _ in range(3):
        n0 = counts()
        planner.plan(cfg, x0, refs)
        assert (counts() - n0 == one).all()


@pytest.mark.parametrize("option", ["resident", "fused", "scan",
                                    "use_pallas", "condensed",
                                    "sqp_iters=2", "resident stage_bf16",
                                    "fused base_box+base_acc"])
def test_plan_makes_no_sync(dev, option):
    """After warm-up a replay and an eager plan make no stream sync and no
    copy from host memory."""
    from apf_quadruped_tpu_torch.runtime import graph
    cfg = _plan_cfg(option)
    x0, refs = _plan_problem(option, cfg, 64, dev, 0)
    graph.clear()
    warm = _warm_from(planner.plan(cfg, x0, refs), 64, 20)
    planner.plan(cfg, x0, refs, warm)
    planner._plan_eager(cfg, x0, refs, warm)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        planner.plan(cfg, x0, refs, warm)
        planner._plan_eager(cfg, x0, refs, warm)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()


def _eager_head(fn, *args):
    """fn(*args) with the cycle's head, its plan and its tail run eagerly
    on the card (the ticks still replay their graph)."""
    from apf_quadruped_tpu_torch.runtime import loop
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(loop, "_cycle_head", loop._cycle_head_eager)
        mp.setattr(loop, "_cycle_tail", loop._cycle_tail_eager)
        mp.setattr(planner, "plan", planner._plan_eager)
        return fn(*args)


@pytest.mark.parametrize("case", ["trot", "height", "crawl", "adaptive"])
def test_cycle_head_makes_no_sync(dev, case):
    """After the first cycle a head replay and an eager head make no
    stream sync and no copy from host memory, nor do a tail's replay and
    the eager tail (on 2 ticks' trace)."""
    from apf_quadruped_tpu_torch.runtime import graph, loop
    cfg, terr, tgt, dist = _graph_case(case, dev)
    graph.clear()
    st = loop.init(cfg, GRAPH_B, device=dev)
    st, _ = loop.run_cycle(cfg, st, terr, tgt, dist)
    head = loop._cycle_head_eager(cfg, st, terr, tgt, dist)
    carry, trace = loop._scan_ticks_eager(cfg, head.cyc, head.carry, 2)
    loop._cycle_tail(cfg, head.tail, carry, trace)     # a 2-tick tail
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        graphed = loop._cycle_head(cfg, st, terr, tgt, dist)
        eager = loop._cycle_head_eager(cfg, st, terr, tgt, dist)
        tail = loop._cycle_tail(cfg, head.tail, carry, trace)
        tail_eager = loop._cycle_tail_eager(cfg, head.tail, carry, trace)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert graphed.n_ticks == eager.n_ticks
    assert graphed.cyc.knot_ratio == eager.cyc.knot_ratio
    _assert_bitwise(graph._tensors(graphed), graph._tensors(eager))
    _assert_bitwise(tail, tail_eager)


def test_sweep_with_graphed_head_equals_eager_head(dev):
    """sweep.run_batch at B=64, two cycles: the cycle's head and tail
    replayed from their graphs against the eager head, plan and tail,
    every result and metric bit for bit; one head, one tail and one tick
    graph cached."""
    from apf_quadruped_tpu_torch.runtime import graph, sweep
    cfg = _short_cycles(sweep.cli_config())
    scn = sweep.random_scenarios(cfg, 64, seed=5, use_native=False,
                                 device=dev)
    graph.clear()
    graphed = sweep.run_batch(cfg, scn, 2)
    assert len(_calls()) == 2 and len(_ticks()) == 1
    eager = _eager_head(sweep.run_batch, cfg, scn, 2)
    _assert_bitwise(graphed, eager)
    assert len(_calls()) == 2


# ---------------------------------------------------------------------------
# wbc.solve and solve_qp replayed from captured CUDA graphs
# (runtime/graph.call) against their eager bodies, bit for bit
# ---------------------------------------------------------------------------

# the cases of tests/test_torch_wbc_graph.py: (ref_exact, cone bases,
# contact, crawl), the crawl flag a per-lane tensor or a Python bool
WBC_CASES = {f"ref_exact={r} cone_rot={c} {m}": (r, c, m, "lanes")
             for r in (False, True) for c in (False, True)
             for m in ("standing", "trot")}
WBC_CASES |= {f"ref_exact=True trot crawl={v}": (True, False, "trot", v)
              for v in (False, True)}


def _wbc_case(name, B, dev, seed=0):
    """(cfg, WbcState, WbcRefs) in float32 on the card: the WBC latency
    benchmark's states (problems.wbc_problem) with the case's branches."""
    from apf_quadruped_tpu_torch.sim import terrain
    ref_exact, cone, mode, crawl = WBC_CASES[name]
    cfg = EngineConfig(wbc=WbcConfig(ref_exact=ref_exact,
                                     slack_weight_trot=1e6))
    st, ref = problems.wbc_problem(cfg, B, seed=seed, device=dev)
    gen = torch.Generator(dev).manual_seed(seed)
    if mode == "trot":
        st = st._replace(contact=torch.tensor(
            [1.0, 0.0, 0.0, 1.0], device=dev).expand(B, 4))
    if cone:
        n = torch.randn(B, 4, 3, generator=gen, device=dev) * 0.2
        n[..., 2] = 1.0
        st = st._replace(cone_rot=terrain.basis_from_normal(
            n / torch.linalg.vector_norm(n, dim=-1, keepdim=True)))
    else:
        st = st._replace(cone_rot=None)
    st = st._replace(crawl=torch.arange(B, device=dev) % 2 == 1
                     if crawl == "lanes" else crawl)
    ref = ref._replace(
        com_pos=ref.com_pos + torch.tensor([0.0, 0.02, -0.03], device=dev),
        com_vel=torch.randn(B, 3, generator=gen, device=dev) * 0.1,
        swing_pos=torch.randn(B, 4, 3, generator=gen, device=dev) * 0.02)
    return cfg, st, ref


def _assert_same_bits(a, b):
    """Every tensor leaf equal in dtype, shape and bits, NaN included."""
    from apf_quadruped_tpu_torch.runtime import graph
    la, lb = graph._tensors(a), graph._tensors(b)
    assert len(la) == len(lb)
    for i, (x, y) in enumerate(zip(la, lb)):
        assert x.dtype == y.dtype and x.shape == y.shape, i
        if x.is_floating_point():
            x, y = x.view(torch.int32), y.view(torch.int32)
        assert torch.equal(x, y), i


def _wbc_graphs():
    from apf_quadruped_tpu_torch import wbc
    from apf_quadruped_tpu_torch.ops import qpsolve
    return [e for e in _calls()
            if isinstance(e.outs, (wbc.WbcOutput, qpsolve.QPSolution))]


@pytest.mark.parametrize("B", [1, 64, 1024])
@pytest.mark.parametrize("case", list(WBC_CASES))
def test_graphed_wbc_equals_eager(dev, case, B):
    """wbc.solve on the card replays one graph, captured on one draw of
    states and replayed on another, each bit for bit the eager body's and
    finite, not all zero.  (A drawn lane may stay unconverged within the
    iteration budget, eager and graphed alike.)"""
    from apf_quadruped_tpu_torch import wbc
    from apf_quadruped_tpu_torch.runtime import graph
    graph.clear()
    for seed in (0, 1):
        cfg, st, ref = _wbc_case(case, B, dev, seed)
        out = wbc.solve(cfg, st, ref)
        _assert_same_bits(out, wbc._solve_eager(cfg, st, ref))
        assert len(graph.entries()) == 1
        assert bool(torch.isfinite(out.tau).all())
        assert bool((out.tau != 0).any())
    graph.clear()


def _free_qp(rng, B, dev):
    """A make_qp QP with no equality rows (its one padded row masked)."""
    from apf_quadruped_tpu_torch.ops import qpsolve
    n, m = 30, 68
    M = rng.normal(size=(B, n, n))
    G = rng.normal(size=(B, m, n))
    data = [np.einsum("bij,bkj->bik", M, M) / n + np.eye(n),
            rng.normal(size=(B, n)), G, rng.uniform(0.5, 1.0, (B, m))]
    return qpsolve.make_qp(*(torch.as_tensor(v, dtype=torch.float32,
                                             device=dev) for v in data))


@pytest.mark.parametrize("B", [1, 64, 1024])
@pytest.mark.parametrize("kind", ["wbc standing", "wbc ref_exact trot",
                                  "no equality rows"])
def test_graphed_qp_equals_eager(rng, dev, kind, B):
    """solve_qp on the card replays one graph a configuration and QP
    layout, bit for bit its eager body on WBC-shaped QPs and on a make_qp
    QP with no equality rows."""
    from apf_quadruped_tpu_torch import wbc
    from apf_quadruped_tpu_torch.ops import qpsolve
    from apf_quadruped_tpu_torch.runtime import graph
    graph.clear()
    for seed in (0, 1):
        if kind == "no equality rows":
            cfg_s, qp = SolverConfig(), _free_qp(rng, B, dev)
        else:
            name = ("ref_exact=False cone_rot=False standing"
                    if kind == "wbc standing"
                    else "ref_exact=True cone_rot=True trot")
            cfg, st, ref = _wbc_case(name, B, dev, seed)
            cfg_s, (qp, _) = cfg.solver, wbc._build_qp(cfg, st, ref)
        sol = qpsolve.solve_qp(qp, cfg_s)
        _assert_same_bits(sol, qpsolve._solve_qp_eager(qp, cfg_s))
        assert len(graph.entries()) == 1
        assert bool(torch.isfinite(sol.x).all())
        assert bool((sol.x != 0).any())
    graph.clear()


def test_graphed_wbc_quarantines_a_nan_lane(dev):
    """A NaN in one lane's joint angles through the cached graph: the QP
    comes back zero and unconverged in that lane, the others finite, every
    output bit for bit the eager body's."""
    from apf_quadruped_tpu_torch import wbc
    from apf_quadruped_tpu_torch.runtime import graph
    cfg, st, ref = _wbc_case("ref_exact=False cone_rot=False standing", 64,
                             dev)
    graph.clear()
    wbc.solve(cfg, st, ref)                   # capture on finite data
    q = st.q.clone()
    q[1, 0] = float("nan")
    st = st._replace(q=q)
    out = wbc.solve(cfg, st, ref)
    assert len(graph.entries()) == 1
    assert not bool(out.sol.converged[1])
    assert bool((out.sol.x[1] == 0).all())
    assert bool(torch.isfinite(out.sol.x).all())
    assert bool(torch.isfinite(torch.cat([out.tau[:1], out.tau[2:]])).all())
    _assert_same_bits(out, wbc._solve_eager(cfg, st, ref))
    graph.clear()


@pytest.mark.parametrize("fn", ["wbc.solve", "solve_qp"])
def test_graphed_wbc_counts_one_calls_launches(dev, fn):
    """The counters advance by an eager call's launches (one resident QP
    launch, no SPD kernel) at the capturing call and at each replay."""
    from apf_quadruped_tpu_torch import wbc
    from apf_quadruped_tpu_torch.ops import cuda_chol, qpsolve
    from apf_quadruped_tpu_torch.runtime import graph
    counters = (cuda_chol.chol_factor, cuda_chol.chol_sub,
                cuda_chol.chol_solve, cuda_qp.solve_qp_resident)

    def counts():
        return np.array([f.launches for f in counters])

    cfg, st, ref = _wbc_case("ref_exact=True cone_rot=True trot", 64, dev)
    qp, _ = wbc._build_qp(cfg, st, ref)
    eager, graphed = {
        "wbc.solve": (lambda: wbc._solve_eager(cfg, st, ref),
                      lambda: wbc.solve(cfg, st, ref)),
        "solve_qp": (lambda: qpsolve._solve_qp_eager(qp, cfg.solver),
                     lambda: qpsolve.solve_qp(qp, cfg.solver))}[fn]
    n0 = counts()
    eager()
    one = counts() - n0
    assert tuple(one) == (0, 0, 0, 1)
    graph.clear()
    for _ in range(3):
        n0 = counts()
        graphed()
        assert (counts() - n0 == one).all()
    graph.clear()


@pytest.mark.parametrize("case", ["ref_exact=False cone_rot=False standing",
                                  "ref_exact=True cone_rot=True trot",
                                  "ref_exact=True trot crawl=True"])
def test_wbc_replay_makes_no_sync(dev, case):
    """After the capture a replay of wbc.solve and of solve_qp makes no
    stream sync and no copy from host memory."""
    from apf_quadruped_tpu_torch import wbc
    from apf_quadruped_tpu_torch.ops import qpsolve
    from apf_quadruped_tpu_torch.runtime import graph
    cfg, st, ref = _wbc_case(case, 64, dev)
    qp, _ = wbc._build_qp(cfg, st, ref)
    graph.clear()
    wbc.solve(cfg, st, ref)
    qpsolve.solve_qp(qp, cfg.solver)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        wbc.solve(cfg, st, ref)
        qpsolve.solve_qp(qp, cfg.solver)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    assert len(graph.entries()) == 2
    graph.clear()


def test_graphed_sweep_holds_no_wbc_graph(dev):
    """sweep.run_batch at B=64: the WBC solve runs inside the tick's graph
    (no graph of its own is cached), and the tick graph's launches a
    replay are an eager tick's, its WBC solve eager too."""
    from apf_quadruped_tpu_torch import wbc
    from apf_quadruped_tpu_torch.ops import qpsolve
    from apf_quadruped_tpu_torch.runtime import graph, loop, sweep
    cfg = _short_cycles(sweep.cli_config())
    scn = sweep.random_scenarios(cfg, 64, seed=0, use_native=False,
                                 device=dev)
    seen = {}
    real = loop._scan_ticks

    def spy(cfg_, cyc, carry, n):
        seen.update(cyc=cyc, carry=carry)
        return real(cfg_, cyc, carry, n)

    graph.clear()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(loop, "_scan_ticks", spy)
        res = sweep.run_batch(cfg, scn, 1)
    (entry,) = _ticks()
    assert len(_calls()) == 2 and _wbc_graphs() == []
    n0 = graph._counts()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(wbc, "solve", wbc._solve_eager)
        mp.setattr(qpsolve, "solve_qp", qpsolve._solve_qp_eager)
        loop._scan_ticks_eager(cfg, seen["cyc"], seen["carry"], 1)
    one = tuple(b - a for a, b in zip(n0, graph._counts()))
    assert entry.launches == one
    # physics' 4 mass-matrix factors and the WBC's one resident QP launch
    assert entry.launches[0] == 4 and entry.launches[-1] == 1
    assert len(graph.entries()) == 3
    assert bool(torch.isfinite(res.final_com).all())
    graph.clear()


# ---------------------------------------------------------------------------
# stage marks (runtime/profiling.mark) in the captured graphs, and the
# graph spans (runtime/graph.py) on the card
# ---------------------------------------------------------------------------

def _marked_case(what, dev):
    """(fn() of one unit of `what` on the card, the units a call makes:
    {unit's first stage: count})."""
    from apf_quadruped_tpu_torch import wbc
    from apf_quadruped_tpu_torch.runtime import loop
    if what in ("tick", "tick height"):
        cfg, terr, tgt, dist = _graph_case(
            "height" if what == "tick height" else "trot", dev)
        st = loop.init(cfg, GRAPH_B, device=dev)
        n_ticks = int(round(cfg.gait.trot_cycle / cfg.sim.dt))
        return (lambda: loop.run_cycle(cfg, st, terr, tgt, dist),
                {"tick.refs": n_ticks, "plan.pack": 1})
    if what.startswith("wbc"):
        B = int(what.split("B=")[1])
        cfg, st, ref = _wbc_case("ref_exact=True cone_rot=True trot", B,
                                 dev)
        return lambda: wbc.solve(cfg, st, ref), {"wbc.build": 1}
    option = what.split(" ", 1)[1]
    cfg = _plan_cfg(option)
    x0, refs = _plan_problem(option, cfg, 64, dev, 0)
    return (lambda: planner.plan(cfg, x0, refs),
            {"plan.pack": cfg.mpc.sqp_iters})


# the stages of each unit, by its first stage
_UNIT_STAGES = {"tick.refs": ("tick.refs", "wbc.build", "wbc.qp",
                              "wbc.torque", "wbc.end", "physics",
                              "tick.tail", "tick.end"),
                "wbc.build": ("wbc.build", "wbc.qp", "wbc.torque",
                              "wbc.end"),
                "plan.pack": ("plan.pack", "plan.ipm", "plan.unpack")}

MARKED = ["tick", "tick height", "wbc B=1", "wbc B=64", "plan resident",
          "plan fused", "plan sqp_iters=2"]


def _mark_counts(fn, tries=4):
    """{stage: marks recorded} in a profile of fn() (fenced), profiled
    again, up to `tries` times, where the profiler lost any of the port's
    counted launches."""
    import collections

    from apf_quadruped_tpu_torch.runtime import graph, profiling
    from portbench import marked, trace as ptrace
    for _ in range(tries):
        before = sum(graph._counts())

        def fenced():
            fn()
            torch.cuda.synchronize()
        tr = ptrace.profile(fenced, graph._counts, min_share=1.0, tries=1)
        if ptrace.counted(tr.kernels) == sum(graph._counts()) - before:
            break
    marks, _ = marked.split(tr.kernels, profiling.STAGES)
    return collections.Counter(s for s, _, _ in marks), tr


@pytest.mark.parametrize("what", MARKED)
def test_marked_graphs_equal_unmarked(dev, what):
    """A graph captured with marks on is a graph of its own, and its
    replay gives the unmarked replay's outputs bit for bit; the launch
    counters advance by the same launches a replay."""
    from apf_quadruped_tpu_torch.runtime import graph, profiling
    fn, _ = _marked_case(what, dev)
    graph.clear()
    plain = fn()
    n = len(graph.entries())
    unmarked = graph.entries()
    with profiling.marks(True):
        marked = fn()
        assert len(graph.entries()) == 2 * n
        n0 = graph._counts()
        again = fn()
        per_marked = tuple(b - a for a, b in zip(n0, graph._counts()))
    n0 = graph._counts()
    fn()
    per_plain = tuple(b - a for a, b in zip(n0, graph._counts()))
    assert len(graph.entries()) == 2 * n
    assert per_marked == per_plain and sum(per_plain) > 0
    news = [e for e in graph.entries() if all(e is not u for u in unmarked)]
    assert sorted(e.launches for e in news) == sorted(e.launches
                                                      for e in unmarked)
    _assert_same_bits(plain, marked)
    _assert_same_bits(plain, again)
    graph.clear()


@pytest.mark.parametrize("what", MARKED)
def test_marked_replay_records_each_mark_once_per_unit(dev, what):
    """A profile of one marked replay holds each of a unit's marks once a
    unit, and nothing else; an unmarked replay, its marked graph cached
    beside it, records no mark."""
    from apf_quadruped_tpu_torch.runtime import graph, profiling
    fn, units = _marked_case(what, dev)
    graph.clear()
    fn()
    with profiling.marks(True):
        fn()
        counts, tr = _mark_counts(fn)
    want = {s: n for first, n in units.items()
            for s in _UNIT_STAGES[first]}
    if "plan.pack" in units:     # one end a plan, whatever its SQP steps
        want["plan.end"] = 1
    if what == "tick height":    # the cone bases, and each substep's lookups
        from apf_quadruped_tpu_torch.runtime import sweep
        per_tick = 1 + sweep.cli_config().sim.substeps
        want["ground"] = units["tick.refs"] * per_tick
        want["physics"] = units["tick.refs"] * per_tick
    assert dict(counts) == want, (counts, tr.share)
    counts, tr = _mark_counts(fn)
    assert not counts and not any("apf_mark_kernel" in n
                                  for n, _, _ in tr.kernels)
    graph.clear()


def test_graph_spans_nest_on_the_card(dev):
    """Under a profiler a graph's capture, and each call's and scan's
    inputs, replay and outputs, are spans named by the graph's key; a
    cycle holds its head's call, its ticks' scan and its tail's call."""
    from apf_quadruped_tpu_torch.runtime import graph
    fn_wbc, _ = _marked_case("wbc B=1", dev)
    fn_tick, _ = _marked_case("tick", dev)
    graph.clear()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        fn_wbc()
        fn_wbc()
        fn_tick()
    names = [e.name for e in prof.events() if e.name.startswith("apf: ")]
    for n in ("apf: graph.capture wbc", "apf: graph.capture tick",
              "apf: graph.capture cycle head", "apf: graph.scan tick",
              "apf: graph.call cycle head", "apf: graph.call cycle tail",
              "apf: loop.run_cycle", "apf: loop.scan_ticks"):
        assert n in names, n
    assert names.count("apf: graph.call wbc") == 2
    calls = [e for e in prof.events() if e.name == "apf: graph.call wbc"]
    for part in ("apf: inputs", "apf: replay", "apf: outputs"):
        inside = [e for e in prof.events() if e.name == part
                  and calls[1].time_range.start <= e.time_range.start
                  and e.time_range.end <= calls[1].time_range.end]
        assert len(inside) == 1, part
    graph.clear()
