"""SolverConfig.stage_bf16 in the port against the JAX package.

The option stores the stage linearizations A and B at bfloat16 and
widens them to float32 inside the kernels of the resident and fused
backends; the scan, use_pallas and condensed ignore it.  On the CPU the
port's resident and fused routes run their plain versions on A and B
rounded to bfloat16, and are held here to the JAX package's kernels in
interpret mode with the option set, at the JAX suite's gate
(tests/test_pallas_riccati.py): converged and iters equal, u and x
within 5e-5.  The same problem's float32 answer differs by more than
1e-3, so the gate tells the two apart.  Inputs are made with numpy from a
seed; both sides get explicit float32 (tests/conftest.py turns on x64).

The JAX resident kernel and the scan differ in the accel rows' cold start
(ROADMAP Queue 3, "Standing divergences"), and the port follows the scan,
so plans with accel rows are held to the JAX scan on the stage QP with A
and B rounded by JAX, which is what the JAX resident kernel reads.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apf_quadruped_tpu import planner as jplanner
from apf_quadruped_tpu.config import EngineConfig as JEngineConfig
from apf_quadruped_tpu.config import MpcConfig as JMpcConfig
from apf_quadruped_tpu.config import SolverConfig as JSolverConfig
from apf_quadruped_tpu.ops import riccati as jr
from apf_quadruped_tpu.ops.pallas_riccati import (solve_stage_qp_fused,
                                                  solve_stage_qp_resident)
from apf_quadruped_tpu_torch import convert, planner, problems
from apf_quadruped_tpu_torch.config import EngineConfig, MpcConfig, SolverConfig
from apf_quadruped_tpu_torch.ops import cuda_riccati as cr
from apf_quadruped_tpu_torch.ops import riccati as tr

torch.set_num_threads(1)

TEST = dict(iters=15, reltol=1e-4, abstol=1e-4, static_reg=1e-6, w_clip=1e6)
CFG = SolverConfig(**TEST)
CFG16 = SolverConfig(**TEST, stage_bf16=True)
JCFG16 = JSolverConfig(**TEST, stage_bf16=True)
ATOL = 5e-5
H, B = 6, 4


def _jax_bf16(x):
    """JAX's rounding of float32 x to bfloat16, as uint16 bit patterns."""
    return np.asarray(jnp.asarray(x, jnp.float32).astype(jnp.bfloat16)
                      ).view(np.uint16)


def _torch_bf16(x):
    return torch.as_tensor(np.asarray(x, np.float32)).to(
        torch.bfloat16).view(torch.int16).numpy().view(np.uint16)


def _f32_bits(bits):
    return np.asarray(bits, np.uint32).view(np.float32)


@pytest.mark.parametrize("kind", ["normal", "ties", "subnormal", "specials"])
def test_rounding_matches_jax_bit_for_bit(rng, kind):
    """torch's cast to bfloat16 is jnp.astype(jnp.bfloat16), bit for bit:
    round to nearest, ties to even, subnormals kept, signs and infinities
    kept; a NaN stays a NaN."""
    if kind == "normal":
        x = np.concatenate([rng.normal(size=2000), rng.normal(size=2000)
                            * 10.0 ** rng.integers(-30, 30, 2000)]
                           ).astype(np.float32)
    elif kind == "ties":
        # exactly halfway between two bf16 values: the low 16 bits 0x8000,
        # above a kept mantissa that is even and one that is odd
        hi = rng.integers(0, 0x7F7F, 2000, dtype=np.uint32) << 16
        x = _f32_bits(np.concatenate([hi | 0x8000, (hi | 0x10000) | 0x8000,
                                      (hi | 0x80000000) | 0x8000]))
    elif kind == "subnormal":
        x = _f32_bits(np.concatenate([
            rng.integers(1, 0x7FFFFF, 2000, dtype=np.uint32),
            rng.integers(1, 0x7FFFFF, 2000, dtype=np.uint32) | 0x80000000,
            np.array([0x8000, 0x18000, 0x7F8000], np.uint32)]))
    else:
        x = np.array([0.0, -0.0, np.inf, -np.inf, np.finfo(np.float32).max,
                      -np.finfo(np.float32).max], np.float32)
    np.testing.assert_array_equal(_torch_bf16(x), _jax_bf16(x))
    if kind == "specials":
        nan = torch.tensor([float("nan")]).to(torch.bfloat16)
        assert bool(nan.isnan().all())
        assert bool(jnp.isnan(jnp.asarray([np.nan], jnp.float32)
                              .astype(jnp.bfloat16)).all())


def _problem(rng, mc=0, **kw):
    return problems.random_stage_qp(rng, B=B, mc=mc, **kw)


def _jax_qp(q):
    return jr.StageQP(**{k: jnp.asarray(v, jnp.float32) for k, v in q.items()})


def _assert_matches(out, ref, atol=ATOL):
    np.testing.assert_array_equal(out.converged.numpy(),
                                  np.asarray(ref.converged))
    np.testing.assert_array_equal(out.iters.numpy(), np.asarray(ref.iters))
    np.testing.assert_allclose(out.u.numpy(), np.asarray(ref.u), rtol=0,
                               atol=atol)
    np.testing.assert_allclose(out.x.numpy(), np.asarray(ref.x), rtol=0,
                               atol=atol)


def _differs(a, b, by=1e-3):
    return float((a.u - b.u).abs().max()) > by


@pytest.mark.parametrize("has_warm", [False, True])
@pytest.mark.parametrize("mc", [0, 6])
def test_resident_matches_jax_interpret(rng, has_warm, mc):
    """cuda_riccati.solve_stage_qp_resident on CPU tensors with stage_bf16
    against the JAX resident kernel in interpret mode with stage_bf16."""
    q = _problem(rng, mc=mc)
    jq, qp = _jax_qp(q), convert.stage_qp(q)
    jwarm = warm = None
    if has_warm:
        cold = solve_stage_qp_resident(jq, JCFG16)
        valid = np.array([True, False, True, True])
        jwarm = jr.WarmStart(u=cold.u, z=cold.z, s=cold.s,
                             valid=jnp.asarray(valid))
        warm = convert.warm_start({"u": np.asarray(cold.u),
                                   "z": np.asarray(cold.z),
                                   "s": np.asarray(cold.s), "valid": valid})
    ref = solve_stage_qp_resident(jq, JCFG16, warm=jwarm)
    assert np.asarray(ref.converged).all()
    out = cr.solve_stage_qp_resident(qp, CFG16, warm)
    _assert_matches(out, ref)
    assert _differs(out, cr.solve_stage_qp_resident(qp, CFG, warm))


def test_fused_matches_jax_interpret(rng):
    """cuda_riccati.solve_stage_qp_fused on CPU tensors with stage_bf16
    against the JAX fused backend (three kernels) in interpret mode."""
    q = _problem(rng)
    ref = solve_stage_qp_fused(_jax_qp(q), JCFG16)
    assert np.asarray(ref.converged).all()
    qp = convert.stage_qp(q)
    out = cr.solve_stage_qp_fused(qp, CFG16)
    _assert_matches(out, ref)
    assert _differs(out, cr.solve_stage_qp_fused(qp, CFG))


def _pass_inputs(rng, nx=6, nu=4, m=6):
    d = {k: torch.as_tensor(v) for k, v in problems.random_stage_qp(
        rng, B=B, H=H, NX=nx, NU=nu, M=m, diag_q=False).items()}
    f32 = dict(dtype=torch.float32)
    mask = d["mask"]
    d.update(u=torch.as_tensor(rng.normal(size=(B, H, nu)), **f32),
             zm=mask * torch.as_tensor(rng.uniform(0.1, 2, (B, H, m)), **f32),
             W=mask * torch.as_tensor(rng.uniform(0.1, 10, (B, H, m)), **f32),
             rx=torch.as_tensor(rng.normal(size=(B, H, nu)), **f32),
             vm=mask * torch.as_tensor(rng.normal(size=(B, H, m)), **f32))
    return d


@pytest.mark.parametrize("name", ["rollout", "factor", "vector"])
def test_plain_pass_on_bf16_is_the_pass_on_rounded_inputs(rng, name):
    """A plain pass given bfloat16 A and Bm is the float32 pass on A and Bm
    rounded to bfloat16, bit for bit: the plain version of each bf16
    kernel."""
    d = _pass_inputs(rng)
    A16, B16 = d["A"].to(torch.bfloat16), d["B"].to(torch.bfloat16)
    Ar, Br = A16.float(), B16.float()
    assert not torch.equal(Ar, d["A"])

    def run(A, Bm):
        if name == "rollout":
            return cr.plain_rollout(d["G"], d["R"], d["Q"], A, Bm, d["qlin"],
                                    d["u"], d["zm"], d["x0"])
        F = cr.plain_factor_pass(d["G"], d["R"], d["Q"], Ar, Br, d["W"])
        if name == "factor":
            return cr.plain_factor_pass(d["G"], d["R"], d["Q"], A, Bm, d["W"])
        return cr.plain_vector_pass(d["G"], A, Bm, *F, d["rx"], d["vm"])

    for a, b in zip(run(A16, B16), run(Ar, Br)):
        assert a.dtype == torch.float32
        assert torch.equal(a, b)


def test_bf16_knots_layout(rng):
    """bf16_knots: each knot's matrix starts on 16 bytes, rounded as torch
    (and so JAX) rounds; its view holds the rounded matrix."""
    A = torch.as_tensor(rng.normal(size=(3, 5, 13, 13)), dtype=torch.float32)
    v = cr.bf16_knots(A)
    assert v.dtype == torch.bfloat16 and v.shape == A.shape
    assert v.stride() == (5 * 176, 176, 13, 1)
    assert torch.equal(v, A.to(torch.bfloat16))
    assert cr._in_bf16_layout(v) and not cr._in_bf16_layout(
        A.to(torch.bfloat16))


def _cfg(backend="riccati_resident", bf16=True, **mpc):
    return EngineConfig(mpc=MpcConfig(horizon=H, dt=0.025, backend=backend,
                                      **mpc),
                        solver=SolverConfig(stage_bf16=bf16))


def _jcfg(cfg):
    return JEngineConfig(mpc=JMpcConfig(**dataclasses.asdict(cfg.mpc)),
                         solver=JSolverConfig(**dataclasses.asdict(
                             cfg.solver)))


def _jax_plan(cfg, x0, refs):
    jrefs = jplanner.MpcRefs(**{k: None if v is None else jnp.asarray(v)
                                for k, v in convert.to_numpy(refs)._asdict()
                                .items()})
    return jplanner.plan(_jcfg(cfg), jnp.asarray(x0.numpy()), jrefs)


def _assert_plans_match(tout, jforces, jstates, jconv, jiters):
    """tests/test_torch_planner.py's gate: converged and iters equal,
    forces within 1e-3 max(1, |f|max), states within 1e-4."""
    np.testing.assert_array_equal(tout.sol.converged.numpy(), jconv)
    np.testing.assert_array_equal(tout.sol.iters.numpy(), jiters)
    f = np.asarray(jforces).reshape(tout.forces.shape)
    np.testing.assert_allclose(tout.forces.numpy(), f, rtol=0,
                               atol=1e-3 * max(1.0, np.abs(f).max()))
    np.testing.assert_allclose(tout.states.numpy(), np.asarray(jstates),
                               rtol=0, atol=1e-4)


def test_plan_matches_jax_resident_interpret():
    """planner.plan(backend="riccati_resident") with stage_bf16 on the CPU
    against the JAX planner's resident kernel in interpret mode."""
    cfg = _cfg()
    x0, refs = problems.bench_problem(cfg, B, device="cpu")
    ref = _jax_plan(cfg, x0, refs)
    assert np.asarray(ref.sol.converged).all()
    out = planner.plan(cfg, x0, refs)
    _assert_plans_match(out, ref.forces, ref.states, ref.sol.converged,
                        ref.sol.iters)
    f32 = planner.plan(_cfg(bf16=False), x0, refs)
    assert float((out.forces - f32.forces).abs().max()) > 1e-3


@pytest.mark.parametrize("backend", ["riccati_resident", "riccati_fused"])
def test_plan_with_accel_rows_matches_jax_rounding(backend):
    """base_box + base_acc (state rows and accel rows; riccati_fused
    reroutes to the resident kernel): the plan with stage_bf16 is the JAX
    scan's solve of the plan's stage QP with A and B rounded by JAX, so the
    accel rows' offsets come from the rounded A, as in the JAX kernel."""
    cfg = _cfg(backend, base_box=True, base_acc=True)
    x0, refs = problems.bench_problem(cfg, B, device="cpu")
    q = convert.to_numpy(planner.stage_qp(cfg, x0, refs))._asdict()
    jq = jr.StageQP(**{k: None if v is None else jnp.asarray(v, jnp.float32)
                       for k, v in q.items()})
    jq = jq._replace(A=jq.A.astype(jnp.bfloat16).astype(jnp.float32),
                     B=jq.B.astype(jnp.bfloat16).astype(jnp.float32))
    ref = jr.solve_stage_qp(jq, JSolverConfig())
    assert np.asarray(ref.converged).all()
    out = planner.plan(cfg, x0, refs)
    _assert_plans_match(out, ref.u, ref.x, ref.converged, ref.iters)
    f32 = planner.plan(_cfg(backend, bf16=False, base_box=True,
                            base_acc=True), x0, refs)
    assert float((out.forces - f32.forces).abs().max()) > 1e-3


def test_auto_plan_on_cpu_matches_jax():
    """backend "auto" resolves to the scan off the card in both packages,
    and the scan ignores stage_bf16: the port's plan equals the JAX
    package's under the same config."""
    cfg = _cfg("auto")
    assert planner.effective_backend(cfg, "cpu") == "riccati"
    x0, refs = problems.bench_problem(cfg, B, device="cpu")
    ref = _jax_plan(cfg, x0, refs)
    assert np.asarray(ref.sol.converged).all()
    _assert_plans_match(planner.plan(cfg, x0, refs), ref.forces, ref.states,
                        ref.sol.converged, ref.sol.iters)


@pytest.mark.parametrize("backend,solver", [
    ("riccati", {}), ("riccati", dict(use_pallas=True)),
    ("condensed", dict(iters=40, reltol=1e-6, abstol=1e-5))])
def test_backends_without_kernels_ignore_stage_bf16(backend, solver):
    """The scan, the scan with use_pallas and the condensed backend give
    the float32 plan bit for bit with stage_bf16 set, as in the JAX
    package."""
    x0, refs = problems.bench_problem(_cfg(backend), B, device="cpu")

    def run(bf16):
        cfg = EngineConfig(mpc=MpcConfig(horizon=H, dt=0.025,
                                         backend=backend),
                           solver=SolverConfig(stage_bf16=bf16, **solver))
        return planner.plan(cfg, x0, refs)
    a, b = run(True), run(False)
    for f in ("forces", "states"):
        assert torch.equal(getattr(a, f), getattr(b, f)), f
    for f in ("converged", "iters", "gap", "res_norm", "z", "s"):
        assert torch.equal(getattr(a.sol, f), getattr(b.sol, f)), f
    qp = planner.stage_qp(_cfg(backend), x0, refs)
    s16, s32 = tr.solve_stage_qp(qp, CFG16), tr.solve_stage_qp(qp, CFG)
    for f in ("u", "x", "z", "s", "iters"):
        assert torch.equal(getattr(s16, f), getattr(s32, f)), f
