"""The fused Riccati IPM of the port (ops/cuda_riccati.py) against the JAX
package's (apf_quadruped_tpu/ops/pallas_riccati.py), on the CPU.

  * each pass's plain version (plain_rollout, plain_factor_pass,
    plain_vector_pass) against the TPU kernel it stands for (_rollout_call,
    _factor_call, _vector_call, run in interpret mode) on the same numpy
    inputs in float32, small dims, the JAX calls in their batch-last layout
    padded to 128 lanes; atol 1e-5 (a few float32 roundings of O(1) sums);
  * solve_stage_qp_fused against the JAX package's solve_stage_qp_fused
    (interpret mode) and against the port's scan IPM under the JAX suite's
    gates (tests/test_pallas_riccati.py): converged equal, u/x at atol 5e-5,
    2e-4 with dense Q/R, 1e-4 at B=130; the all-masked, active-constraint,
    unbatched and NaN-lane cases; warm against cold.
The kernels themselves run on the card (tests/test_torch_cuda.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apf_quadruped_tpu.config import SolverConfig as JSolverConfig
from apf_quadruped_tpu.ops import pallas_riccati as jpr
from apf_quadruped_tpu.ops.riccati import StageQP as JStageQP
from apf_quadruped_tpu_torch import convert, problems
from apf_quadruped_tpu_torch.config import SolverConfig
from apf_quadruped_tpu_torch.ops import cuda_riccati as cr
from apf_quadruped_tpu_torch.ops import riccati as tr

torch.set_num_threads(1)

CFG = SolverConfig(iters=15, reltol=1e-4, abstol=1e-4,
                   static_reg=1e-6, w_clip=1e6)
JCFG = JSolverConfig(iters=15, reltol=1e-4, abstol=1e-4,
                     static_reg=1e-6, w_clip=1e6)
LANES = 128


def _bl(x):
    """(B, H, ...) numpy -> the JAX calls' (H, ..., 128) float32 layout."""
    x = np.moveaxis(np.asarray(x, np.float32), 0, -1)
    pad = [(0, 0)] * (x.ndim - 1) + [(0, LANES - x.shape[-1])]
    return jnp.asarray(np.pad(x, pad))


def _bf(x, B):
    """Back from the batch-last layout to (B, H, ...)."""
    return np.moveaxis(np.asarray(x)[..., :B], -1, 0)


def _pass_inputs(rng, B=4, H=4, NX=6, NU=4, M=6, diag_q=False):
    q = problems.random_stage_qp(rng, B=B, H=H, NX=NX, NU=NU, M=M,
                                 diag_q=diag_q)
    f32 = lambda v: np.asarray(v, np.float32)   # noqa: E731
    q.update(u=f32(rng.normal(size=(B, H, NU))),
             zm=f32(q["mask"] * rng.uniform(0.1, 2.0, (B, H, M))),
             W=f32(q["mask"] * rng.uniform(0.1, 10.0, (B, H, M))),
             rx=f32(rng.normal(size=(B, H, NU))),
             vm=f32(q["mask"] * rng.normal(size=(B, H, M))))
    q["Rreg"] = f32(q["R"] + 1e-6 * np.eye(NU))
    return q


def _t(v):
    return torch.as_tensor(v)


def _close(port, ref, atol=1e-5):
    np.testing.assert_allclose(port.numpy(), ref, rtol=0, atol=atol)


@pytest.mark.parametrize("diag_q", [True, False])
def test_plain_rollout_matches_tpu_kernel(rng, diag_q):
    d = _pass_inputs(rng, diag_q=diag_q)
    x, rx, gu = jpr._rollout_call(
        jnp.asarray(d["G"]), jnp.asarray(d["R"]), jnp.asarray(d["Q"]),
        _bl(d["A"]), _bl(d["B"]), _bl(d["qlin"]), _bl(d["u"]), _bl(d["zm"]),
        _bl(d["x0"][:, None])[0], interpret=True)
    px, prx, pgu = cr.plain_rollout(*map(_t, (d["G"], d["R"], d["Q"], d["A"],
                                              d["B"], d["qlin"], d["u"],
                                              d["zm"], d["x0"])))
    B = d["x0"].shape[0]
    _close(px, _bf(x, B))
    _close(prx, _bf(rx, B))
    _close(pgu, _bf(gu, B))


@pytest.mark.parametrize("diag_q", [True, False])
def test_plain_factor_pass_matches_tpu_kernel(rng, diag_q):
    d = _pass_inputs(rng, H=5, diag_q=diag_q)
    G = d["G"]
    nu, m = G.shape[1], G.shape[0]
    GG = np.einsum("mi,mj->ijm", G, G).reshape(nu * nu, m)
    L, D, K = jpr._factor_call(jnp.asarray(GG), jnp.asarray(d["Rreg"]),
                               jnp.asarray(d["Q"]), _bl(d["A"]), _bl(d["B"]),
                               _bl(d["W"]), interpret=True)
    pL, pD, pK = cr.plain_factor_pass(*map(_t, (G, d["Rreg"], d["Q"], d["A"],
                                                d["B"], d["W"])))
    B = d["x0"].shape[0]
    _close(pL, _bf(L, B))
    _close(pD, _bf(D, B))
    _close(pK, _bf(K, B))
    assert bool((torch.triu(pL, 1) == 0).all())


def test_plain_vector_pass_matches_tpu_kernel(rng):
    d = _pass_inputs(rng, H=5)
    L, D, K = cr.plain_factor_pass(*map(_t, (d["G"], d["Rreg"], d["Q"],
                                             d["A"], d["B"], d["W"])))
    du, gdu = jpr._vector_call(
        jnp.asarray(d["G"]), _bl(d["A"]), _bl(d["B"]), _bl(L.numpy()),
        _bl(D.numpy()), _bl(K.numpy()), _bl(d["rx"]), _bl(d["vm"]),
        interpret=True)
    pdu, pgdu = cr.plain_vector_pass(*map(_t, (d["G"], d["A"], d["B"])), L, D,
                                     K, _t(d["rx"]), _t(d["vm"]))
    B = d["x0"].shape[0]
    _close(pdu, _bf(du, B))
    _close(pgdu, _bf(gdu, B))


def test_passes_on_cpu_launch_nothing(rng):
    """CPU tensors take the plain versions: the wrappers count no launch
    and return the plain versions' results."""
    d = _pass_inputs(rng)
    before = (cr.fused_rollout.launches, cr.fused_factor.launches,
              cr.fused_vector.launches)
    args = tuple(map(_t, (d["G"], d["R"], d["Q"], d["A"], d["B"], d["qlin"],
                          d["u"], d["zm"], d["x0"])))
    for a, b in zip(cr.fused_rollout(*args), cr.plain_rollout(*args)):
        assert torch.equal(a, b)
    f = cr.fused_factor(*map(_t, (d["G"], d["Rreg"], d["Q"], d["A"], d["B"],
                                  d["W"])))
    cr.fused_vector(*map(_t, (d["G"], d["A"], d["B"])), *f, _t(d["rx"]),
                    _t(d["vm"]))
    assert (cr.fused_rollout.launches, cr.fused_factor.launches,
            cr.fused_vector.launches) == before


# ---------------------------------------------------------------------------
# the fused IPM
# ---------------------------------------------------------------------------

def _problem(rng, **kw):
    return problems.random_stage_qp(rng, **kw)


def _jqp(d):
    return JStageQP(**{k: jnp.asarray(v) for k, v in d.items()})


def _assert_matches(out, ref_u, ref_x, ref_conv, atol):
    np.testing.assert_array_equal(out.converged.numpy(), ref_conv)
    np.testing.assert_allclose(out.u.numpy(), ref_u, rtol=0, atol=atol)
    np.testing.assert_allclose(out.x.numpy(), ref_x, rtol=0, atol=atol)


@pytest.mark.parametrize("case,kw,atol", [
    ("default", {}, 5e-5),
    ("dense_costs", dict(diag_q=False), 2e-4),
    ("lane_boundary", dict(B=130, H=3, NX=4, NU=3, M=4), 1e-4)])
def test_fused_matches_jax_fused(rng, case, kw, atol):
    d = _problem(rng, **kw)
    ref = jpr.solve_stage_qp_fused(_jqp(d), JCFG, interpret=True)
    out = cr.solve_stage_qp_fused(convert.stage_qp(d), CFG)
    assert np.asarray(ref.converged).all()
    _assert_matches(out, np.asarray(ref.u), np.asarray(ref.x),
                    np.asarray(ref.converged), atol)
    np.testing.assert_array_equal(out.iters.numpy(), np.asarray(ref.iters))


@pytest.mark.parametrize("case,kw,atol", [
    ("default", {}, 5e-5),
    ("dense_costs", dict(diag_q=False), 2e-4),
    ("all_masked", dict(mask_frac=0.0), 5e-5),
    ("lane_boundary", dict(B=130, H=3, NX=4, NU=3, M=4), 1e-4),
    ("mpc_sized", dict(B=3, H=20, NX=13, NU=12, M=24), 2e-4)])
def test_fused_matches_scan(rng, case, kw, atol):
    qp = convert.stage_qp(_problem(rng, **kw))
    ref = tr.solve_stage_qp(qp, CFG)
    out = cr.solve_stage_qp_fused(qp, CFG)
    assert bool(ref.converged.all())
    _assert_matches(out, ref.u.numpy(), ref.x.numpy(),
                    ref.converged.numpy(), atol)
    assert torch.equal(out.iters, ref.iters)
    assert out.z.shape == ref.z.shape and out.s.shape == ref.s.shape


def test_fused_active_constraints(rng):
    """Tight bounds: the fused solution is feasible on the real rows."""
    d = _problem(rng)
    d["h"] = np.full_like(d["h"], 0.05)
    d["qlin"] = d["qlin"] * 5.0
    sol = cr.solve_stage_qp_fused(convert.stage_qp(d), CFG)
    viol = (np.einsum("mn,bhn->bhm", d["G"], sol.u.numpy()) - 0.05) * d["mask"]
    assert viol.max() < 1e-4


def test_fused_unbatched(rng):
    """Scalar batch shape () round-trips through the flat batch axis."""
    d = _problem(rng, B=1)
    for k in ("A", "B", "qlin", "mask", "x0"):
        d[k] = d[k][0]
    qp = convert.stage_qp(d)
    ref = tr.solve_stage_qp(qp, CFG)
    out = cr.solve_stage_qp_fused(qp, CFG)
    assert out.u.shape == ref.u.shape and out.converged.shape == ()
    np.testing.assert_allclose(out.u.numpy(), ref.u.numpy(), rtol=0,
                               atol=5e-5)


def test_fused_nan_quarantine(rng):
    """A poisoned lane comes back zeroed and unconverged with gap and
    residual inf; the healthy lanes are unaffected."""
    d = _problem(rng)
    clean = cr.solve_stage_qp_fused(convert.stage_qp(d), CFG)
    d["x0"][1, 0] = np.nan
    sol = cr.solve_stage_qp_fused(convert.stage_qp(d), CFG)
    assert bool(torch.isfinite(sol.u).all() & torch.isfinite(sol.z).all())
    assert not bool(sol.converged[1])
    assert bool((sol.u[1] == 0).all())
    assert float(sol.gap[1]) == float(sol.res_norm[1]) == float("inf")
    for b in (0, 2, 3):
        np.testing.assert_allclose(sol.u[b].numpy(), clean.u[b].numpy(),
                                   rtol=0, atol=5e-5)


def test_fused_warm_start(rng):
    """A warm start from the cold solution converges in fewer iterations,
    as the scan IPM's does from the same warm start; an all-invalid warm
    start is the cold solve."""
    qp = convert.stage_qp(_problem(rng, B=8, H=6, NX=13, NU=12, M=24))
    cold = cr.solve_stage_qp_fused(qp, CFG)
    valid = torch.tensor([True] * 7 + [False])
    warm = cr.solve_stage_qp_fused(qp, CFG, tr.WarmStart(
        u=cold.u, z=cold.z, s=cold.s, valid=valid))
    assert bool(warm.converged.all())
    assert int(warm.iters[:7].max()) < int(cold.iters[:7].min())
    assert int(warm.iters[7]) == int(cold.iters[7])
    ref = tr.solve_stage_qp(qp, CFG, tr.WarmStart(u=cold.u, z=cold.z,
                                                  s=cold.s, valid=valid))
    assert torch.equal(warm.iters, ref.iters)
    _assert_matches(warm, ref.u.numpy(), ref.x.numpy(), ref.converged.numpy(),
                    2e-4)
    off = tr.WarmStart(u=torch.full_like(cold.u, 3.0),
                       z=torch.full_like(cold.z, 5.0),
                       s=torch.full_like(cold.s, 7.0),
                       valid=torch.zeros(8, dtype=torch.bool))
    again = cr.solve_stage_qp_fused(qp, CFG, off)
    for f in ("u", "x", "z", "s", "converged", "iters", "gap", "res_norm"):
        assert torch.equal(getattr(again, f), getattr(cold, f)), f


def test_fused_rejects_state_and_accel_rows(rng):
    for kw in (dict(mc=6), dict(acc=True, NX=13, NU=12, M=24)):
        qp = convert.stage_qp(_problem(rng, **kw))
        with pytest.raises(ValueError, match="resident"):
            cr.solve_stage_qp_fused(qp, CFG)
    qp = convert.stage_qp(_problem(rng))


def _pad_as_the_kernels(d, NX=13, NU=12, MP=24):
    """The problem as csrc/fused_riccati.cu's kernels stage it at their
    compile-time widths: A, B, Q, G (rows and columns), W, rx, vm, u, zm,
    q and x0 padded with zeros, R (and its regularised copy) with an
    identity block."""
    def pad(v, shape):
        out = np.zeros(v.shape[:v.ndim - len(shape)] + shape)
        out[tuple(slice(0, n) for n in v.shape)] = v
        return out
    def pad_r(R):
        out = pad(R, (NU, NU))
        out[range(R.shape[0], NU), range(R.shape[0], NU)] = 1.0
        return out
    return dict(G=pad(d["G"], (MP, NU)), Rreg=pad_r(d["Rreg"]),
                R=pad_r(d["R"]), Q=pad(d["Q"], (NX, NX)),
                A=pad(d["A"], (NX, NX)), B=pad(d["B"], (NX, NU)),
                W=pad(d["W"], (MP,)), rx=pad(d["rx"], (NU,)),
                vm=pad(d["vm"], (MP,)), u=pad(d["u"], (NU,)),
                zm=pad(d["zm"], (MP,)), qlin=pad(d["qlin"], (NX,)),
                x0=pad(d["x0"], (NX,)))


def test_kernel_padding_is_exact(rng):
    """The factor and vector kernels run nx <= 13, nu <= 12, m <= 24 at
    13 / 12 / 24, padded as each knot is staged: the plain passes on the
    padded problem, sliced back, give the unpadded outputs (float64, to
    1e-12), with L, dinv and K exactly I, 1 and 0 on the padded block and
    du, gdu exactly 0 on the padded inputs and rows."""
    nx, nu, m = 6, 4, 8
    d = {k: np.asarray(v, np.float64)
         for k, v in _pass_inputs(rng, B=3, H=5, NX=nx, NU=nu, M=m).items()}
    p = _pad_as_the_kernels(d)
    names = ("G", "Rreg", "Q", "A", "B", "W")
    L, D, K = cr.plain_factor_pass(*(_t(d[k]) for k in names))
    Lp, Dp, Kp = cr.plain_factor_pass(*(_t(p[k]) for k in names))
    close = dict(rtol=0, atol=1e-12)
    torch.testing.assert_close(Lp[..., :nu, :nu], L, **close)
    torch.testing.assert_close(Dp[..., :nu], D, **close)
    torch.testing.assert_close(Kp[..., :nu, :nx], K, **close)
    eye = torch.eye(12, dtype=torch.float64)
    assert torch.equal(Lp[..., nu:, :], eye[nu:].expand_as(Lp[..., nu:, :]))
    assert torch.equal(Lp[..., :nu, nu:], torch.zeros_like(Lp[..., :nu, nu:]))
    assert torch.equal(Dp[..., nu:], torch.ones_like(Dp[..., nu:]))
    assert torch.equal(Kp[..., nu:, :], torch.zeros_like(Kp[..., nu:, :]))
    assert torch.equal(Kp[..., nx:], torch.zeros_like(Kp[..., nx:]))
    du, gdu = cr.plain_vector_pass(_t(d["G"]), _t(d["A"]), _t(d["B"]), L, D,
                                   K, _t(d["rx"]), _t(d["vm"]))
    dup, gdup = cr.plain_vector_pass(_t(p["G"]), _t(p["A"]), _t(p["B"]), Lp,
                                     Dp, Kp, _t(p["rx"]), _t(p["vm"]))
    torch.testing.assert_close(dup[..., :nu], du, **close)
    torch.testing.assert_close(gdup[..., :m], gdu, **close)
    assert torch.equal(dup[..., nu:], torch.zeros_like(dup[..., nu:]))
    assert torch.equal(gdup[..., m:], torch.zeros_like(gdup[..., m:]))


@pytest.mark.parametrize("MP", [24, 32])
def test_rollout_padding_is_exact(rng, MP):
    """The rollout kernel runs nx <= 13, nu <= 12, m <= 24 (or 32) at
    13 / 12 / 24 (32), padded as each knot is staged: plain_rollout on the
    padded problem, sliced back, gives the unpadded x, rx and gu (float64,
    to 1e-12), and the padded x, rx and gu are exactly 0."""
    nx, nu, m = 6, 4, 8
    d = {k: np.asarray(v, np.float64)
         for k, v in _pass_inputs(rng, B=3, H=5, NX=nx, NU=nu, M=m).items()}
    p = _pad_as_the_kernels(d, MP=MP)
    names = ("G", "R", "Q", "A", "B", "qlin", "u", "zm", "x0")
    x, rx, gu = cr.plain_rollout(*(_t(d[k]) for k in names))
    xp, rxp, gup = cr.plain_rollout(*(_t(p[k]) for k in names))
    close = dict(rtol=0, atol=1e-12)
    torch.testing.assert_close(xp[..., :nx], x, **close)
    torch.testing.assert_close(rxp[..., :nu], rx, **close)
    torch.testing.assert_close(gup[..., :m], gu, **close)
    for v, n in ((xp, nx), (rxp, nu), (gup, m)):
        assert torch.equal(v[..., n:], torch.zeros_like(v[..., n:]))
