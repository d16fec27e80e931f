"""What lets wbc.solve and solve_qp be captured, on the CPU.

On the card `wbc.solve` (one whole-body tick) and `ops/qpsolve.solve_qp`
replay captured CUDA graphs (runtime/graph.call), the counterparts of the
JAX package's jitted `wbc.solve` and `solve_qp`.  A capture cannot hold a
copy from host memory or a read back to the host.  Here: CPU tensors
never reach the graph and the public functions equal their eager bodies
bit for bit; after a first call a second call of each body builds no
tensor from host data, in every case the body branches on (the
reference-exact formulation on and off, cone bases or none, standing and
trot contact, the crawl flag a tensor or a bool); the crawl flag masks
the equality rows as it did before it stopped being copied to the
device; the graphs' key tells those layouts apart; and the port's
problem of the WBC latency benchmark, solved, agrees with the JAX
package's jitted, vmapped `wbc.solve` on the same states.  The capture
and the replay need the card (tests/test_torch_cuda.py, chip_smoke.py
phase 22).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_parity_inputs import close
from apf_quadruped_tpu import wbc as jwbc
from apf_quadruped_tpu.config import EngineConfig as JEngineConfig
from apf_quadruped_tpu.models import rbd as jrbd
from apf_quadruped_tpu.sim import physics as jphys
from apf_quadruped_tpu_torch import problems, wbc
from apf_quadruped_tpu_torch.config import EngineConfig, WbcConfig
from apf_quadruped_tpu_torch.ops import qpsolve
from apf_quadruped_tpu_torch.runtime import graph
from apf_quadruped_tpu_torch.sim import terrain

torch.set_num_threads(1)

F64 = torch.float64
B = 4
TROT = (1.0, 0.0, 0.0, 1.0)

# every branch of the body: (ref_exact, cone bases, contact, crawl), the
# crawl flag a per-lane tensor (mixed lanes) or a Python bool
CASES = {f"ref_exact={r} cone_rot={c} {m}": (r, c, m, "lanes")
         for r in (False, True) for c in (False, True)
         for m in ("standing", "trot")}
CASES |= {f"ref_exact=True trot crawl={v}": (True, False, "trot", v)
          for v in (False, True)}


def _case(name, seed=0):
    """(cfg, WbcState, WbcRefs) of one case, from the WBC latency
    benchmark's states (problems.wbc_problem) with the case's branches and
    references away from the state, so that the QP has work to do."""
    ref_exact, cone, mode, crawl = CASES[name]
    cfg = EngineConfig(wbc=WbcConfig(ref_exact=ref_exact,
                                     slack_weight_trot=1e6))
    st, ref = problems.wbc_problem(cfg, B, seed=seed, dtype=F64,
                                   device="cpu")
    gen = torch.Generator().manual_seed(seed)
    if mode == "trot":
        st = st._replace(contact=torch.tensor(TROT, dtype=F64).expand(B, 4))
    if cone:
        n = torch.randn(B, 4, 3, generator=gen, dtype=F64) * 0.2
        n[..., 2] = 1.0
        st = st._replace(cone_rot=terrain.basis_from_normal(
            n / torch.linalg.vector_norm(n, dim=-1, keepdim=True)))
    else:
        st = st._replace(cone_rot=None)
    st = st._replace(crawl=torch.tensor([False, True, False, True])
                     if crawl == "lanes" else crawl)
    ref = ref._replace(
        com_pos=ref.com_pos + torch.tensor([0.0, 0.02, -0.03], dtype=F64),
        com_vel=torch.randn(B, 3, generator=gen, dtype=F64) * 0.1,
        swing_pos=torch.randn(B, 4, 3, generator=gen, dtype=F64) * 0.02)
    return cfg, st, ref


def _bitwise(a, b):
    la, lb = graph._tensors(a), graph._tensors(b)
    assert len(la) == len(lb)
    for i, (x, y) in enumerate(zip(la, lb)):
        assert x.dtype == y.dtype and x.shape == y.shape, i
        if x.is_floating_point():
            x, y = x.view(torch.int64), y.view(torch.int64)
        assert torch.equal(x, y), i


def _refuse_graph(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("graph.call called on the CPU")
    monkeypatch.setattr(graph, "call", refuse)


def _count_host_builds(monkeypatch):
    """Count torch.tensor and torch.as_tensor calls from here on."""
    calls = []
    for name in ("tensor", "as_tensor"):
        real = getattr(torch, name)

        def counted(*a, _real=real, _name=name, **k):
            calls.append(_name)
            return _real(*a, **k)
        monkeypatch.setattr(torch, name, counted)
    return calls


# ---------------------------------------------------------------------------
# the route: CPU tensors never reach the graph
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", list(CASES))
def test_cpu_solves_run_the_eager_bodies(monkeypatch, case):
    """wbc.solve and solve_qp on CPU tensors never reach graph.call and
    equal _solve_eager and _solve_qp_eager bit for bit."""
    cfg, st, ref = _case(case)
    _refuse_graph(monkeypatch)
    out = wbc.solve(cfg, st, ref)
    _bitwise(out, wbc._solve_eager(cfg, st, ref))
    assert bool(out.sol.converged.any())
    qp, _ = wbc._build_qp(cfg, st, ref)
    _bitwise(qpsolve.solve_qp(qp, cfg.solver),
             qpsolve._solve_qp_eager(qp, cfg.solver))


def test_cpu_qp_without_equality_rows_runs_eagerly(monkeypatch, rng):
    """A make_qp QP with no equality rows (its one padded row masked),
    as the condensed planner builds them."""
    _refuse_graph(monkeypatch)
    n, m = 12, 20
    M = rng.normal(size=(B, n, n))
    G = rng.normal(size=(B, m, n))
    qp = qpsolve.make_qp(np.einsum("bij,bkj->bik", M, M) / n + np.eye(n),
                         rng.normal(size=(B, n)), G,
                         rng.uniform(0.5, 1.0, (B, m)))
    sol = qpsolve.solve_qp(qp)
    _bitwise(sol, qpsolve._solve_qp_eager(qp, qpsolve.SolverConfig()))
    assert bool(sol.converged.all())


def test_graph_call_refuses_the_wbc_on_the_cpu():
    cfg, st, ref = _case(next(iter(CASES)))
    with pytest.raises(ValueError, match="CUDA graph"):
        graph.call(("wbc", cfg), lambda a: wbc._solve_eager(cfg, *a),
                   (st, ref))


def test_wbc_key_tells_layouts_apart():
    """The layout the WBC graph is keyed on differs with cone_rot None
    or a tensor and with the crawl flag a tensor, True or False, each of
    which the body branches on."""
    _, st, ref = _case("ref_exact=True cone_rot=True trot")
    sig = graph._signature
    layouts = [st, st._replace(cone_rot=None), st._replace(crawl=True),
               st._replace(crawl=False)]
    assert len({sig((s, ref)) for s in layouts}) == 4


# ---------------------------------------------------------------------------
# a second solve builds nothing from host data
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", list(CASES))
def test_second_solve_builds_nothing_from_host(monkeypatch, case):
    """After a first WBC solve, a second one on other states (the QP's
    build, its solve and the torque map) and a second QP solve call
    neither torch.tensor nor torch.as_tensor."""
    cfg, st, ref = _case(case, seed=0)
    wbc._solve_eager(cfg, st, ref)
    cfg, st, ref = _case(case, seed=1)
    calls = _count_host_builds(monkeypatch)
    out = wbc._solve_eager(cfg, st, ref)
    qp, _ = wbc._build_qp(cfg, st, ref)
    sol = qpsolve._solve_qp_eager(qp, cfg.solver)
    assert calls == []
    assert bool(torch.isfinite(out.tau).all())
    _bitwise(sol, out.sol)


@pytest.mark.parametrize("crawl", ["lanes", False, True])
def test_crawl_masks_the_swing_rows_as_before(crawl):
    """With ref_exact's trot-swing quirk the equality rhs b is zeroed
    where legs swing outside crawl.  The flag now stays where it is (a
    tensor) or a Python branch (a bool): b equals the old construction,
    which copied the flag to the device with torch.as_tensor, bit for
    bit."""
    name = ("ref_exact=True cone_rot=False trot" if crawl == "lanes"
            else f"ref_exact=True trot crawl={crawl}")
    cfg, st, ref = _case(name)
    qp, _ = wbc._build_qp(cfg, st, ref)
    raw, _ = wbc._build_qp(cfg.replace(wbc=WbcConfig(
        ref_exact=True, slack_weight_trot=1e6, ref_exact_swing_b0=False)),
        st, ref)
    old = (st.contact.amin(dim=-1) < 0.5) & ~torch.as_tensor(st.crawl)
    _bitwise(qp.b, torch.where(old[..., None], torch.zeros_like(raw.b),
                               raw.b))
    assert not torch.equal(qp.b, raw.b) or crawl is True


# ---------------------------------------------------------------------------
# the WBC latency benchmark's problem against the JAX package
# ---------------------------------------------------------------------------

@functools.cache
def _jax_solve():
    return jax.jit(jax.vmap(lambda s, r: jwbc.solve(JEngineConfig(), s, r)))


@pytest.mark.parametrize("contact", ["standing", "trot"])
def test_wbc_problem_matches_jax(contact):
    """problems.wbc_problem at B=4 in float64 against the states
    benchmarks/wbc_latency.py draws (the JAX spawn, q jittered by
    N(0, 0.02), u by N(0, 0.01), seed 0; the CoM reference from the JAX
    package's rbd), then the port's wbc.solve against the JAX package's
    jitted, vmapped wbc.solve at EngineConfig() (standing, as the
    benchmark, and a trot contact mask).  Tolerances of
    tests/test_torch_wbc_physics.py::test_wbc_solve_matches_jax: converged
    and iters equal, tau, udot and forces within 1e-6 of their largest
    entry."""
    cfg = EngineConfig()
    st, ref = problems.wbc_problem(cfg, B, seed=0, dtype=F64, device="cpu")
    rng = np.random.default_rng(0)
    st0 = jphys.initial_state(JEngineConfig(), (0.0, 0.0), 0.0, jnp.float64)
    q = np.asarray(st0.q)[None] + rng.normal(size=(B, 12)) * 0.02
    u = rng.normal(size=(B, 18)) * 0.01
    contact_np = np.broadcast_to(TROT if contact == "trot" else 1.0, (B, 4))
    j_st = jwbc.WbcState(
        p_base=jnp.broadcast_to(st0.p_base, (B, 3)),
        R_wb=jnp.broadcast_to(st0.R_wb, (B, 3, 3)), q=jnp.asarray(q),
        u=jnp.asarray(u), contact=jnp.asarray(contact_np),
        crawl=jnp.zeros(B, bool),
        cone_rot=jnp.broadcast_to(jnp.eye(3), (B, 4, 3, 3)))
    com = jax.vmap(lambda p, R, qq: jrbd.com_position(
        JEngineConfig().robot, p, R, qq))(j_st.p_base, j_st.R_wb, j_st.q)
    z3, z43 = jnp.zeros((B, 3)), jnp.zeros((B, 4, 3))
    j_ref = jwbc.WbcRefs(com_pos=com, com_vel=z3, com_acc=z3, rpy=z3,
                         omega=z3, omega_dot=z3, swing_pos=z43,
                         swing_vel=z43, swing_acc=z43)
    for name in ("p_base", "R_wb", "q", "u", "cone_rot"):
        close(getattr(st, name), getattr(j_st, name), 1e-12)
    close(st.crawl, j_st.crawl, 0)
    close(ref.com_pos, com, 1e-12)
    st = st._replace(contact=torch.as_tensor(np.array(contact_np)))
    out_j = _jax_solve()(j_st, j_ref)
    out_t = wbc.solve(cfg, st, ref)
    close(out_t.sol.converged, out_j.sol.converged, 0)
    close(out_t.sol.iters, out_j.sol.iters, 0)
    for f in ("tau", "udot", "forces"):
        close(getattr(out_t, f), getattr(out_j, f),
              1e-6 * max(1.0, float(np.abs(getattr(out_j, f)).max())))
