"""The port's stage-QP Riccati IPM vs the JAX package's.

apf_quadruped_tpu_torch.ops.riccati.solve_stage_qp (plain PyTorch, the
CPU path and the plain version of the CUDA kernel) is held to the JAX
scan IPM in all 8 has_warm x state-rows x accel-rows variants, and to the
JAX resident Pallas kernel (interpret mode) at the shapes the JAX suite
runs un-slow.  Gates are the JAX package's own cross-backend gates
(tests/test_pallas_riccati.py): converged and iters exactly equal, u/x at
atol 5e-5 in float32; 1e-9 in float64.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apf_quadruped_tpu.ops import riccati as jr
from apf_quadruped_tpu.ops.pallas_riccati import solve_stage_qp_resident
from apf_quadruped_tpu_torch import convert, problems
from apf_quadruped_tpu_torch.config import SolverConfig
from apf_quadruped_tpu_torch.ops import cuda_riccati
from apf_quadruped_tpu_torch.ops import riccati as tr

torch.set_num_threads(1)

CFG = SolverConfig(iters=15, reltol=1e-4, abstol=1e-4,
                   static_reg=1e-6, w_clip=1e6)
ATOL = {np.float32: 5e-5, np.float64: 1e-9}
VARIANTS = [(warm, mc, acc) for warm in (False, True) for mc in (0, 6)
            for acc in (False, True)]


def _problem(rng, mc=0, acc=False, dtype=np.float32, **kw):
    # the accel rows assume the 13-state SRB layout
    dims = dict(NX=13, NU=12, M=24) if acc else {}
    q = problems.random_stage_qp(rng, mc=mc, acc=acc, **(dims | kw))
    return {k: v.astype(dtype) for k, v in q.items()}


def _jax_qp(q):
    return jr.StageQP(**{k: jnp.asarray(v) for k, v in q.items()})


def _warm(sol, valid):
    """WarmStart (numpy fields) from a solution's u/z/s."""
    return dict(u=np.asarray(sol.u), z=np.asarray(sol.z),
                s=np.asarray(sol.s), valid=np.asarray(valid))


def _jax_warm(w):
    return None if w is None else jr.WarmStart(
        **{k: jnp.asarray(v) for k, v in w.items()})


def _assert_same(ref, out, atol):
    np.testing.assert_array_equal(out.converged.numpy(),
                                  np.asarray(ref.converged))
    np.testing.assert_array_equal(out.iters.numpy(), np.asarray(ref.iters))
    for f in ("u", "x", "z", "s", "zx", "sx"):
        r = getattr(ref, f)
        if r is None:
            assert getattr(out, f) is None
            continue
        assert getattr(out, f).shape == np.asarray(r).shape, f
    np.testing.assert_allclose(out.u.numpy(), np.asarray(ref.u), rtol=0,
                               atol=atol)
    np.testing.assert_allclose(out.x.numpy(), np.asarray(ref.x), rtol=0,
                               atol=atol)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("has_warm,mc,acc", VARIANTS)
def test_plain_matches_jax_scan(rng, has_warm, mc, acc, dtype):
    q = _problem(rng, mc=mc, acc=acc, dtype=dtype)
    warm = None
    if has_warm:
        cold = jr.solve_stage_qp(_jax_qp(q), CFG)
        warm = _warm(cold, [True, False, True, True])
    ref = jr.solve_stage_qp(_jax_qp(q), CFG, warm=_jax_warm(warm))
    assert np.asarray(ref.converged).all()
    out = tr.solve_stage_qp(convert.stage_qp(q), CFG,
                            None if warm is None else convert.warm_start(warm))
    _assert_same(ref, out, ATOL[dtype])
    if has_warm and not mc:
        # warm lanes start at the previous optimum and stop early (with
        # state rows their zx/sx still start cold)
        its = out.iters.numpy()
        assert (its[[0, 2, 3]] < np.asarray(
            jr.solve_stage_qp(_jax_qp(q), CFG).iters)[[0, 2, 3]]).all()


@pytest.mark.parametrize("has_warm", [False, True])
def test_plain_matches_jax_resident_interpret(rng, has_warm):
    """Against the JAX resident Pallas kernel in interpret mode, at the
    shapes tests/test_pallas_riccati.py runs un-slow."""
    q = _problem(rng)
    cold = solve_stage_qp_resident(_jax_qp(q), CFG)
    warm = _warm(cold, [True, True, False, True]) if has_warm else None
    ref = solve_stage_qp_resident(_jax_qp(q), CFG, warm=_jax_warm(warm))
    out = tr.solve_stage_qp(convert.stage_qp(q), CFG,
                            None if warm is None else convert.warm_start(warm))
    _assert_same(ref, out, ATOL[np.float32])


def test_nan_lane_quarantined(rng):
    """A poisoned lane comes back zeroed and unconverged, as in the JAX
    package; healthy lanes are unaffected."""
    q = _problem(rng)
    q["x0"][1, 0] = np.nan
    ref = jr.solve_stage_qp(_jax_qp(q), CFG)
    out = tr.solve_stage_qp(convert.stage_qp(q), CFG)
    assert np.isfinite(out.u.numpy()).all() and np.isfinite(out.z.numpy()).all()
    assert not bool(out.converged[1])
    assert (out.u[1] == 0).all() and (out.x[1] == 0).all()
    assert out.gap[1] == np.inf and out.res_norm[1] == np.inf
    _assert_same(ref, out, ATOL[np.float32])


def test_masked_rows_inert(rng):
    """Changing G and h only where every knot masks a row leaves the
    solution unchanged; all rows masked is the pure LQR of the scan."""
    q = _problem(rng, mask_frac=0.5)
    q["mask"][..., 0] = 0.0                 # row 0 masked everywhere
    base = tr.solve_stage_qp(convert.stage_qp(q), CFG)
    q2 = {k: v.copy() for k, v in q.items()}
    q2["G"][0] *= -3.0
    q2["h"][0] = 0.01
    moved = tr.solve_stage_qp(convert.stage_qp(q2), CFG)
    np.testing.assert_array_equal(moved.u.numpy(), base.u.numpy())
    np.testing.assert_array_equal(moved.iters.numpy(), base.iters.numpy())

    lqr = _problem(rng, mask_frac=0.0)
    _assert_same(jr.solve_stage_qp(_jax_qp(lqr), CFG),
                 tr.solve_stage_qp(convert.stage_qp(lqr), CFG),
                 ATOL[np.float32])


@pytest.mark.parametrize("mc,acc", [(0, False), (6, True)])
def test_invalid_warm_start_equals_cold(rng, mc, acc):
    """An all-False WarmStart reproduces the cold solve bit for bit."""
    q = _problem(rng, mc=mc, acc=acc)
    qp = convert.stage_qp(q)
    cold = tr.solve_stage_qp(qp, CFG)
    B, H = q["x0"].shape[0], q["A"].shape[1]
    nu, mt = q["B"].shape[-1], cold.z.shape[-1]
    off = tr.WarmStart(u=torch.full((B, H, nu), 3.0),
                       z=torch.full((B, H, mt), 5.0),
                       s=torch.full((B, H, mt), 7.0),
                       valid=torch.zeros(B, dtype=torch.bool))
    out = tr.solve_stage_qp(qp, CFG, off)
    for f in tr.StageSolution._fields:
        a, b = getattr(out, f), getattr(cold, f)
        if a is None:
            assert b is None
        else:
            assert torch.equal(a, b), f


def test_resident_wrapper_runs_plain_version_on_cpu(rng):
    """On CPU tensors the kernel's wrapper is its plain version, and no
    kernel launch is counted."""
    qp = convert.stage_qp(_problem(rng, mc=6))
    before = cuda_riccati.solve_stage_qp_resident.launches
    out = cuda_riccati.solve_stage_qp_resident(qp, CFG)
    ref = tr.solve_stage_qp(qp, CFG)
    assert cuda_riccati.solve_stage_qp_resident.launches == before
    for f in tr.StageSolution._fields:
        a, b = getattr(out, f), getattr(ref, f)
        assert (a is None and b is None) or torch.equal(a, b), f


def test_unbatched_problem(rng):
    """Scalar batch shape () round-trips."""
    q = {k: (v[0] if k in ("A", "B", "qlin", "mask", "x0") else v)
         for k, v in _problem(rng).items()}
    ref = jr.solve_stage_qp(_jax_qp(q), CFG)
    out = tr.solve_stage_qp(convert.stage_qp(q), CFG)
    assert out.converged.shape == () and out.u.shape == np.asarray(ref.u).shape
    _assert_same(ref, out, ATOL[np.float32])
