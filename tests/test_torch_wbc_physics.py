"""The port's whole-body QP and physics step vs the JAX package, on the
CPU.

Inputs and comparisons come from tests/test_torch_parity_inputs.py
(float64, a batch of 3).  Tolerances: the QP data and the dynamics within 1e-9 relative;
torques, accelerations and forces within 1e-6 relative (the WBC solve
stops at reltol 1e-6 on a QP with 1e6-weighted swing rows, so two solves
of QPs equal to rounding agree to that tolerance); convergence flags and
iteration counts exactly; one physics step (4 substeps) within 1e-9 on
the state and 1e-7 on the contact forces (stiff penalty springs, O(100) N).
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_parity_inputs import (B, CFG, JCFG, ROBOT, T, close, jv,
                                      slope_terrain, state)
from apf_quadruped_tpu import wbc as jwbc
from apf_quadruped_tpu.config import (SolverConfig as JSolverConfig,
                                      WbcConfig as JWbcConfig)
from apf_quadruped_tpu.models import rbd as jrbd
from apf_quadruped_tpu.sim import physics as jphys
from apf_quadruped_tpu.sim import terrain as jterr
from apf_quadruped_tpu_torch import convert
from apf_quadruped_tpu_torch import wbc as twbc
from apf_quadruped_tpu_torch.config import SolverConfig, WbcConfig
from apf_quadruped_tpu_torch.sim import physics as tphys
from apf_quadruped_tpu_torch.sim import terrain as tterr

torch.set_num_threads(1)


def _wbc_inputs(rng, contact):
    p, R, q, u = state(rng)
    u *= 0.3
    feet = np.asarray(jv(lambda a, b, c: jrbd.foot_positions_world(
        ROBOT, a, b, c))(p, R, q))
    st = dict(p_base=p, R_wb=R, q=q, u=u,
              contact=np.broadcast_to(contact, (B, 4)).astype(float),
              crawl=np.array([False, True, False]),
              cone_rot=np.broadcast_to(np.eye(3), (B, 4, 3, 3)))
    ref = dict(com_pos=p + [0.0, 0.02, -0.03], com_vel=rng.normal(size=(B, 3))
               * 0.1, com_acc=rng.normal(size=(B, 3)),
               rpy=rng.normal(size=(B, 3)) * 0.05,
               omega=rng.normal(size=(B, 3)) * 0.1, omega_dot=np.zeros((B, 3)),
               swing_pos=feet + [0.0, 0.0, 0.05],
               swing_vel=rng.normal(size=(B, 4, 3)) * 0.2,
               swing_acc=rng.normal(size=(B, 4, 3)))
    return st, ref


_WBC = dict(s=dict(iters=20, reltol=1e-6, abstol=1e-7, static_reg=1e-9,
                   eq_reg=1e-9))


@functools.cache
def _jax_wbc(ref_exact):
    """(cfg_j, cfg_t, compiled JAX (QP, WbcOutput) over the batch)."""
    wcfg = dict(slack_weight_trot=1e6, ref_exact=ref_exact)
    cfg_j = JCFG.replace(wbc=JWbcConfig(**wcfg),
                         solver=JSolverConfig(**_WBC["s"]))
    cfg_t = CFG.replace(wbc=WbcConfig(**wcfg),
                        solver=SolverConfig(**_WBC["s"]))
    return cfg_j, cfg_t, jv(lambda s, r: (jwbc._build_qp(cfg_j, s, r)[0],
                                          jwbc.solve(cfg_j, s, r)))


@pytest.mark.parametrize("contact,ref_exact", [
    ((1, 1, 1, 1), False), ((0, 1, 0, 1), False),
    ((1, 1, 1, 1), True), ((0, 1, 0, 1), True)])
def test_wbc_solve_matches_jax(rng, contact, ref_exact):
    """Standing and trot-swing states, the reference-exact formulation on
    and off; the crawl flag differs per lane.  The QP itself and the
    solve."""
    st, ref = _wbc_inputs(rng, contact)
    cfg_j, cfg_t, fn_j = _jax_wbc(ref_exact)
    qp_j, out_j = fn_j(
        jwbc.WbcState(**{k: jnp.asarray(v) for k, v in st.items()}),
        jwbc.WbcRefs(**{k: jnp.asarray(v) for k, v in ref.items()}))
    st_t, ref_t = convert.wbc_state(st), convert.wbc_refs(ref)
    qp_t, _ = twbc._build_qp(cfg_t, st_t, ref_t)
    for a, b in zip(qp_t, qp_j):
        close(a, b, 1e-9 * max(1.0, float(np.abs(np.asarray(b)).max())))
    out_t = twbc.solve(cfg_t, st_t, ref_t)
    close(out_t.sol.converged, out_j.sol.converged, 0)
    close(out_t.sol.iters, out_j.sol.iters, 0)
    for f in ("M", "h_bias", "Jc"):
        close(getattr(out_t, f), getattr(out_j, f), 1e-10)
    # the solve stops at reltol 1e-6 on a QP with 1e6-weighted swing rows:
    # two solves of QPs equal to rounding agree to that tolerance
    for f in ("tau", "udot", "forces"):
        close(getattr(out_t, f), getattr(out_j, f),
              1e-6 * max(1.0, float(np.abs(getattr(out_j, f)).max())))
    # identity cone bases and no cone bases build the same rows
    qp_none, _ = twbc._build_qp(cfg_t, st_t._replace(cone_rot=None), ref_t)
    assert torch.equal(qp_none.G, qp_t.G)


@pytest.mark.parametrize("world", ["flat", "slope"])
def test_physics_step_matches_jax(rng, world):
    """One control step (4 substeps) from a state pressed into the ground,
    with torques, a base push and foot pushes."""
    if world == "flat":
        jt = jterr.flat(JCFG.sim, batch=(B,), dtype=jnp.float64)
        tt = tterr.flat(CFG.sim, batch=(B,), dtype=torch.float64)
    else:
        jt, tt = slope_terrain()
    jst0 = jv(lambda _: jphys.initial_state(JCFG, dtype=jnp.float64))(
        jnp.arange(B))
    st0 = tphys.initial_state(CFG, dtype=torch.float64, batch=(B,))
    for a, b in zip(st0, jst0):
        close(a, b, 1e-12)
    u = rng.normal(size=(B, 18)) * 0.3
    p = np.asarray(jst0.p_base) - [0.0, 0.0, 0.01]
    anchor = np.asarray(jst0.anchor) + rng.normal(size=(B, 4, 2)) * 0.003
    jst = jst0._replace(u=jnp.asarray(u), p_base=jnp.asarray(p),
                        anchor=jnp.asarray(anchor))
    st = convert.to_numpy(st0)._replace(u=u, p_base=p, anchor=anchor)
    st = tphys.SimState(*(T(v) for v in st))
    tau = rng.normal(size=(B, 12)) * 10.0
    fd = rng.normal(size=(B, 3)) * 20.0
    ff = rng.normal(size=(B, 4, 3)) * 5.0
    h_map = jt.h_map if jt.h_map is not None else jnp.zeros(B)
    out_j = jv(lambda s, m, h, a, b, c: jphys.step(
        JCFG, s, a, jt._replace(mu_map=m, h_map=None if world == "flat"
                                else h), f_dist=b, f_feet=c))(
            jst, jt.mu_map, h_map, tau, fd, ff)
    out_t = tphys.step(CFG, st, T(tau), tt, f_dist=T(fd), f_feet=T(ff))
    cf_j = jv(lambda s, m, h: jphys.contact_forces(JCFG, s, jt._replace(
        mu_map=m, h_map=None if world == "flat" else h)))(jst, jt.mu_map,
                                                          h_map)
    for a, b in zip(tphys.contact_forces(CFG, st, tt), cf_j):
        for x, y in zip(a if isinstance(a, tuple) else (a,),
                        b if isinstance(b, tuple) else (b,)):
            if y is not None:
                close(x, y, 1e-9)
    for a, b in zip(out_t[0], out_j[0]):
        close(a, b, 1e-9)
    for a, b in zip(out_t[1], out_j[1]):
        close(a, b, 1e-7)
    assert bool(out_t[1].in_contact.any())
