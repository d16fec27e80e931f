"""The planner's condensed and riccati_fused backends in the port.

  * plan(backend="condensed") against the JAX package's condensed plan in
    float64 at H=10 on bench.py's problem (trot schedule), plain and with
    the base_box rows, the base_acc rows and terrain cone bases: the same
    dense QP through the same IPM, so states and forces agree to float64
    rounding through the IPM (atol 1e-8; forces are O(100) N);
  * the riccati backend against the condensed one with base_box and with
    base_acc, on the JAX suite's own scenarios and tolerances
    (tests/test_planner.py test_base_box_riccati_matches_condensed and
    test_base_acc_riccati_matches_condensed): the two backends describe
    the same constraint set;
  * riccati_fused: its plan agrees with the scan's, and with base_box or
    base_acc it resolves to the resident kernel (on the CPU the scan).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apf_quadruped_tpu import planner as jplanner
from apf_quadruped_tpu_torch import convert, planner, problems
from apf_quadruped_tpu_torch.config import EngineConfig, MpcConfig, SolverConfig
from apf_quadruped_tpu_torch.models import srb
from apf_quadruped_tpu_torch.models.dogbot import nominal_stance
from apf_quadruped_tpu_torch.ops import riccati as tr

torch.set_num_threads(1)
f64 = torch.float64


def _with(cfg, **mpc):
    return dataclasses.replace(cfg, mpc=dataclasses.replace(cfg.mpc, **mpc))


def _cone_rot(rng, B, H):
    """(B, H, 4, 3, 3) rotations within ~0.2 rad of the world frame."""
    w = rng.normal(size=(B, H, 4, 3)) * 0.12
    th = np.linalg.norm(w, axis=-1)[..., None, None]
    k = w / np.linalg.norm(w, axis=-1, keepdims=True)
    K = np.zeros(w.shape[:-1] + (3, 3))
    K[..., 0, 1], K[..., 0, 2], K[..., 1, 2] = -k[..., 2], k[..., 1], -k[..., 0]
    K = K - np.swapaxes(K, -1, -2)
    return np.eye(3) + np.sin(th) * K + (1 - np.cos(th)) * K @ K


@pytest.mark.parametrize("case", ["plain", "base_box", "base_acc",
                                  "cone_rot"])
def test_condensed_matches_jax(rng, case):
    B, H = 3, 10
    cfg = EngineConfig(
        mpc=MpcConfig(horizon=H, dt=0.05, backend="condensed",
                      base_box=case == "base_box",
                      base_acc=case == "base_acc"),
        solver=SolverConfig(iters=30, reltol=1e-6, abstol=1e-6,
                            static_reg=1e-9, eq_reg=1e-9))
    x0, refs = problems.bench_problem(cfg, B, dtype=f64, device="cpu")
    if case == "cone_rot":
        refs = refs._replace(cone_rot=torch.as_tensor(_cone_rot(rng, B, H)))
    jrefs = jplanner.MpcRefs(**{k: None if v is None else jnp.asarray(v)
                                for k, v in convert.to_numpy(refs)._asdict()
                                .items()})
    ref = jplanner.plan(cfg, jnp.asarray(x0.numpy()), jrefs)
    out = planner.plan(cfg, x0, refs)
    assert out.forces.shape == (B, H, 4, 3) and out.states.shape == (B, H, 13)
    np.testing.assert_array_equal(out.sol.converged.numpy(),
                                  np.asarray(ref.sol.converged))
    np.testing.assert_array_equal(out.sol.iters.numpy(),
                                  np.asarray(ref.sol.iters))
    np.testing.assert_allclose(out.states.numpy(), np.asarray(ref.states),
                               rtol=0, atol=1e-8)
    np.testing.assert_allclose(out.forces.numpy(), np.asarray(ref.forces),
                               rtol=0, atol=1e-8)
    assert out.sol.z.shape == np.asarray(ref.sol.z).shape


def _standing_refs(cfg, com0, com_des):
    """The JAX suite's single-scenario standing problem (tests/
    test_planner.py _acc_refs)."""
    H = cfg.mpc.horizon
    feet0 = torch.as_tensor(nominal_stance(cfg.robot)) + com0
    feet0[:, 2] = 0.0
    contacts = torch.ones((H, 4), dtype=f64)
    return planner.MpcRefs(
        contacts=contacts,
        feet_w=planner.foothold_schedule(feet0, feet0, contacts),
        x_ref=planner.reference_trajectory(
            cfg, torch.zeros(3, dtype=f64), com0, com_des,
            torch.tensor(0.0, dtype=f64),
            torch.tensor(H * cfg.mpc.dt, dtype=f64)),
        yaw_ref=torch.tensor(0.0, dtype=f64))


def _riccati_vs_condensed(mk, sol_cfg, com_des):
    cfg_r = EngineConfig(mpc=MpcConfig(**mk, backend="riccati"),
                         solver=sol_cfg)
    cfg_c = _with(cfg_r, backend="condensed")
    com0 = torch.tensor([0.0, 0.0, 0.4], dtype=f64)
    z3 = torch.zeros(3, dtype=f64)
    x0 = srb.pack_state(z3, com0, z3, z3)
    refs = _standing_refs(cfg_r, com0, torch.tensor(com_des, dtype=f64))
    out_r = planner.plan(cfg_r, x0, refs)
    out_c = planner.plan(cfg_c, x0, refs)
    assert bool(out_r.sol.converged) and bool(out_c.sol.converged)
    xr, xc = out_r.states.numpy(), out_c.states.numpy()
    np.testing.assert_allclose(xr[:, 0:6], xc[:, 0:6], atol=1e-3)
    np.testing.assert_allclose(xr[:, 6:12], xc[:, 6:12], atol=0.02)
    fr, fc = out_r.forces.numpy(), out_c.forces.numpy()
    np.testing.assert_allclose(fr.sum(1), fc.sum(1), atol=5.0)
    return xr, fr, fc


def test_base_box_riccati_matches_condensed():
    xr, fr, fc = _riccati_vs_condensed(
        dict(horizon=10, dt=0.05, base_box=True),
        SolverConfig(iters=60, reltol=1e-4, abstol=1e-3), [0.0, 0.0, 0.65])
    np.testing.assert_allclose(fr[:6], fc[:6], atol=0.35)
    z = xr[:, 5]
    assert 0.5 - 2e-3 <= z.max() <= 0.5 + 2e-3      # it rides the box


def test_base_acc_riccati_matches_condensed():
    _riccati_vs_condensed(
        dict(horizon=10, dt=0.05, base_acc=True, acc_lin_max=1.5,
             acc_ang_max=5.0),
        SolverConfig(iters=60, reltol=1e-5, abstol=1e-3), [0.0, 0.05, 0.6])


def test_condensed_ignores_warm_start():
    cfg = EngineConfig(mpc=MpcConfig(horizon=6, dt=0.025,
                                     backend="condensed"))
    x0, refs = problems.bench_problem(cfg, 2, device="cpu")
    cold = planner.plan(cfg, x0, refs)
    junk = tr.WarmStart(u=torch.full((2, 6, 12), 9.0),
                        z=torch.full((2, 6, 24), 9.0),
                        s=torch.full((2, 6, 24), 9.0),
                        valid=torch.ones(2, dtype=torch.bool))
    warm = planner.plan(cfg, x0, refs, warm=junk)
    assert torch.equal(cold.forces, warm.forces)


def test_effective_backend_resolution():
    cfg = EngineConfig(mpc=MpcConfig(horizon=4))
    for backend in ("riccati", "riccati_resident", "riccati_fused",
                    "condensed"):
        for dev in ("cpu", "cuda"):
            assert planner.effective_backend(
                _with(cfg, backend=backend), dev) == backend
    for box, acc in ((True, False), (False, True), (True, True)):
        c = _with(cfg, backend="riccati_fused", base_box=box, base_acc=acc)
        assert planner.effective_backend(c, "cuda") == "riccati_resident"
        assert planner.effective_backend(
            _with(c, backend="condensed"), "cuda") == "condensed"


@pytest.mark.parametrize("rows", [dict(base_box=True), dict(base_acc=True)])
def test_fused_with_rows_reroutes_to_resident(rows):
    """riccati_fused with base_box / base_acc solves through the resident
    backend (on the CPU its plain version, the scan): the same plan."""
    cfg = EngineConfig(mpc=MpcConfig(horizon=6, dt=0.025,
                                     backend="riccati_fused", **rows))
    x0, refs = problems.bench_problem(cfg, 3, device="cpu")
    fused = planner.plan(cfg, x0, refs)
    scan = planner.plan(_with(cfg, backend="riccati"), x0, refs)
    assert torch.equal(fused.forces, scan.forces)
    assert torch.equal(fused.sol.iters, scan.sol.iters)


@pytest.mark.parametrize("case", ["cold", "warm", "sqp2"])
def test_fused_plan_matches_scan_plan(case):
    """The fused backend's plan on bench.py's problem (production widths,
    H=6, B=8, float32) against the scan's: iters equal, forces within
    1e-3 (1 + |f|max), states 1e-4 (tests/test_torch_planner.py's gates)."""
    B, H = 8, 6
    cfg = EngineConfig(mpc=MpcConfig(horizon=H, dt=0.025,
                                     backend="riccati_fused",
                                     sqp_iters=2 if case == "sqp2" else 1))
    x0, refs = problems.bench_problem(cfg, B, device="cpu")
    warm = None
    if case == "warm":
        prev = planner.plan(_with(cfg, backend="riccati"), x0, refs)
        warm = tr.WarmStart(u=prev.forces.reshape(B, H, 12),
                            z=prev.sol.z.reshape(B, H, -1),
                            s=prev.sol.s.reshape(B, H, -1),
                            valid=torch.arange(B) != 3)
    out = planner.plan(cfg, x0, refs, warm=warm)
    ref = planner.plan(_with(cfg, backend="riccati"), x0, refs, warm=warm)
    assert bool(ref.sol.converged.all())
    assert torch.equal(out.sol.converged, ref.sol.converged)
    assert torch.equal(out.sol.iters, ref.sol.iters)
    ftol = 1e-3 * max(1.0, float(ref.forces.abs().max()))
    assert float((out.forces - ref.forces).abs().max()) <= ftol
    assert float((out.states - ref.states).abs().max()) <= 1e-4
