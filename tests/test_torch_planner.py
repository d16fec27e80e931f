"""The port's plan path vs the JAX package's, end to end.

apf_quadruped_tpu_torch.planner.plan on the CPU (the plain Riccati IPM)
against apf_quadruped_tpu.planner.plan(backend="riccati") on bench.py's
problem at production widths (13 states, 12 forces, 24 pyramid rows per
knot), cut to H=6 and B=8, in float32 as the production path runs.
Gates: converged and iters exactly equal; forces within
1e-3 * max(1, |f|max) (forces are O(50) N, and f32 rounding through the
IPM moves them by ~1e-6 relative); states at atol 1e-4.
"""

import dataclasses
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apf_quadruped_tpu import planner as jplanner
from apf_quadruped_tpu.ops.riccati import WarmStart as JWarmStart
from apf_quadruped_tpu_torch import convert, planner, problems
from apf_quadruped_tpu_torch.config import EngineConfig, MpcConfig, SolverConfig
from apf_quadruped_tpu_torch.ops.riccati import solve_stage_qp

torch.set_num_threads(1)

H, B = 6, 8


def _cfg(**mpc):
    return EngineConfig(mpc=MpcConfig(horizon=H, dt=0.025, backend="riccati",
                                      **mpc))


def _cone_rot(rng):
    """(B, H, 4, 3, 3) rotations within ~0.2 rad of the world frame."""
    w = rng.normal(size=(B, H, 4, 3)) * 0.12
    th = np.linalg.norm(w, axis=-1)[..., None, None]
    k = w / np.linalg.norm(w, axis=-1, keepdims=True)
    K = np.zeros(w.shape[:-1] + (3, 3))
    K[..., 0, 1], K[..., 0, 2], K[..., 1, 2] = -k[..., 2], k[..., 1], -k[..., 0]
    K = K - np.swapaxes(K, -1, -2)
    return (np.eye(3) + np.sin(th) * K + (1 - np.cos(th)) * K @ K
            ).astype(np.float32)


def _jax_refs(refs):
    return jplanner.MpcRefs(**{k: None if v is None else jnp.asarray(v)
                               for k, v in convert.to_numpy(refs)._asdict()
                               .items()})


def _assert_plans_match(jout, tout):
    np.testing.assert_array_equal(tout.sol.converged.numpy(),
                                  np.asarray(jout.sol.converged))
    np.testing.assert_array_equal(tout.sol.iters.numpy(),
                                  np.asarray(jout.sol.iters))
    f = np.asarray(jout.forces)
    assert tout.forces.shape == f.shape == (B, H, 4, 3)
    np.testing.assert_allclose(tout.forces.numpy(), f, rtol=0,
                               atol=1e-3 * max(1.0, np.abs(f).max()))
    np.testing.assert_allclose(tout.states.numpy(), np.asarray(jout.states),
                               rtol=0, atol=1e-4)
    for field in ("x", "z", "s", "gap", "res_norm"):
        assert (getattr(tout.sol, field).shape
                == np.asarray(getattr(jout.sol, field)).shape)


@pytest.mark.parametrize("case", ["cold", "warm", "base_box_acc", "cone_rot",
                                  "sqp2"])
def test_plan_matches_jax(rng, case):
    cfg = _cfg(**{"base_box_acc": dict(base_box=True, base_acc=True),
                  "sqp2": dict(sqp_iters=2)}.get(case, {}))
    x0, refs = problems.bench_problem(cfg, B, device="cpu")
    if case == "cone_rot":
        refs = refs._replace(cone_rot=torch.as_tensor(_cone_rot(rng)))
    jx0, jrefs = jnp.asarray(x0.numpy()), _jax_refs(refs)
    jwarm = twarm = None
    if case == "warm":
        # replan from the previous plan, one lane forced cold
        prev = jplanner.plan(cfg, jx0, jrefs)
        Hh = cfg.mpc.horizon
        valid = np.arange(B) != 3
        jwarm = JWarmStart(u=prev.sol.x.reshape(B, Hh, 12),
                           z=prev.sol.z.reshape(B, Hh, -1),
                           s=prev.sol.s.reshape(B, Hh, -1),
                           valid=jnp.asarray(valid))
        twarm = convert.warm_start(jwarm)
    jout = jplanner.plan(cfg, jx0, jrefs, warm=jwarm)
    tout = planner.plan(cfg, x0, refs, warm=twarm)
    assert np.asarray(jout.sol.converged).all()
    _assert_plans_match(jout, tout)
    if case == "warm":
        its = tout.sol.iters.numpy()
        assert its[3] > its[np.arange(B) != 3].max()


def test_plan_standing_forces_carry_the_weight():
    """All four feet in stance and no CoM motion: the feet carry the
    robot's weight."""
    cfg = _cfg()
    x0, refs = problems.bench_problem(cfg, B, device="cpu")
    com = x0[:, 3:6]
    refs = refs._replace(contacts=torch.ones_like(refs.contacts),
                         x_ref=planner.reference_trajectory(
                             cfg, torch.zeros_like(com), com, com,
                             x0[:, 2], torch.full((B,), 0.15)))
    x0 = x0.clone()
    x0[:, 9:12] = 0.0
    out = planner.plan(cfg, x0, refs)
    assert out.sol.converged.all()
    # total normal force at the knots away from the horizon's end
    fz = out.forces[:, :H - 2, :, 2].sum(dim=-1)
    weight = cfg.robot.mass * 9.81
    np.testing.assert_allclose(fz.numpy(), weight, rtol=1e-2)


def test_stage_qp_matches_what_plan_solves(rng):
    """planner.stage_qp is the problem plan() hands the solver."""
    cfg = _cfg(base_box=True, base_acc=True)
    x0, refs = problems.bench_problem(cfg, B, device="cpu")
    qp = planner.stage_qp(cfg, x0, refs)
    assert qp.A.shape == (B, H, 13, 13) and qp.mask.shape == (B, H, 24)
    assert qp.Cx.shape == (6, 13) and qp.acc_rhs.shape == (6,)
    sol = solve_stage_qp(qp, cfg.solver)
    out = planner.plan(cfg, x0, refs)
    assert torch.equal(out.forces, sol.u.reshape(B, H, 4, 3))
    assert torch.equal(out.sol.iters, sol.iters)


def test_auto_backend_on_cpu_is_the_plain_path():
    cfg = dataclasses.replace(_cfg(), mpc=dataclasses.replace(
        _cfg().mpc, backend="auto"))
    x0, refs = problems.bench_problem(cfg, 2, device="cpu")
    assert planner.effective_backend(cfg, x0.device) == "riccati"
    assert planner.effective_backend(cfg, torch.device("cuda")) == \
        "riccati_resident"
    a = planner.plan(cfg, x0, refs)
    b = planner.plan(_cfg(), x0, refs)
    assert torch.equal(a.forces, b.forces)
    c = planner.plan(dataclasses.replace(cfg, mpc=dataclasses.replace(
        cfg.mpc, backend="riccati_resident")), x0, refs)
    assert torch.equal(a.forces, c.forces)


@pytest.mark.parametrize("tag", ["cold", "warm"])
def test_plan_matches_jax_golden(tag):
    """The golden chip_smoke.py holds the GPU run to (written by
    tests/data/make_plan_golden.py with the JAX package) holds on the CPU
    too: B=8, H=20, SolverConfig() defaults."""
    g = np.load(Path(__file__).resolve().parent / "data" / "plan_golden.npz")
    cfg = EngineConfig(mpc=MpcConfig(horizon=20, dt=0.025),
                       solver=SolverConfig())
    refs = convert.mpc_refs({k: g[f"{tag}_{k}"] for k in
                             ("contacts", "feet_w", "x_ref", "yaw_ref")})
    warm = None
    if tag == "warm":
        warm = convert.warm_start({k: g[f"warm_{k}"]
                                   for k in ("u", "z", "s", "valid")})
    out = planner.plan(cfg, convert.tensor(g[f"{tag}_x0"]), refs, warm=warm)
    np.testing.assert_array_equal(out.sol.converged.numpy(),
                                  g[f"{tag}_converged"])
    np.testing.assert_array_equal(out.sol.iters.numpy(), g[f"{tag}_iters"])
    f = g[f"{tag}_forces"]
    np.testing.assert_allclose(out.forces.numpy(), f, rtol=0,
                               atol=1e-3 * max(1.0, np.abs(f).max()))
    np.testing.assert_allclose(out.states.numpy(), g[f"{tag}_states"],
                               rtol=0, atol=1e-4)
