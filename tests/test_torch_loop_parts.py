"""The closed loop's modules in the port vs the JAX package, on the CPU:
gait phases, swing splines, disturbances, kinematics, rigid-body dynamics,
the momentum observer, terrain sampling, APF navigation, foothold
selection and the state converters.

Inputs and comparisons come from tests/test_torch_parity_inputs.py
(float64, a batch of 3).  Tolerances, float64: 1e-10 on kinematics and
dynamics (a few roundings of O(1)-O(100) values, summed in another order;
the port's closed forms against the JAX package's autodiff), 1e-12 on
elementwise code, exact equality for masks, flags, argmin choices and
numpy-built worlds.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_parity_inputs import (B, CFG, JCFG, ROBOT, T, close, jv,
                                      slope_terrain, state)
from apf_quadruped_tpu import apf as japf
from apf_quadruped_tpu import foothold as jfoot
from apf_quadruped_tpu import gait as jgait
from apf_quadruped_tpu import swing as jswing
from apf_quadruped_tpu.models import kinematics as jkin
from apf_quadruped_tpu.models import rbd as jrbd
from apf_quadruped_tpu.runtime import observer as jobs
from apf_quadruped_tpu.sim import disturbance as jdist
from apf_quadruped_tpu.sim import terrain as jterr
from apf_quadruped_tpu_torch import apf as tapf
from apf_quadruped_tpu_torch import convert
from apf_quadruped_tpu_torch import foothold as tfoot
from apf_quadruped_tpu_torch import gait as tgait
from apf_quadruped_tpu_torch import swing as tswing
from apf_quadruped_tpu_torch.config import ApfConfig
from apf_quadruped_tpu_torch.models import dogbot as tdog
from apf_quadruped_tpu_torch.models import kinematics as tkin
from apf_quadruped_tpu_torch.models import rbd as trbd
from apf_quadruped_tpu_torch.runtime import observer as tobs
from apf_quadruped_tpu_torch.sim import disturbance as tdist
from apf_quadruped_tpu_torch.sim import terrain as tterr

torch.set_num_threads(1)


# ---------------------------------------------------------------------------
# gait, swing, disturbance
# ---------------------------------------------------------------------------

def test_phase_info_matches_jax(rng):
    flags = rng.integers(0, tgait.NUM_GAITS, 40)
    t = rng.uniform(0.0, 1.3, 40)
    cycle = rng.uniform(0.4, 1.1, 40)
    out_j = jv(lambda f, tt, c: jgait.phase_info(f, tt, c,
                                                       dtype=jnp.float64))(
        jnp.asarray(flags), jnp.asarray(t), jnp.asarray(cycle))
    out_t = tgait.phase_info(T(flags), T(t), T(cycle), dtype=torch.float64)
    for k in ("contact", "t_start", "t_end"):
        close(out_t[k], out_j[k], 1e-12)


def test_swing_ref_matches_jax(rng):
    p0, p1 = rng.normal(size=(2, B, 4, 3))
    tau = rng.uniform(-0.2, 1.2, (B, 4))
    dur = rng.uniform(0.1, 0.4, (B, 4))
    out_j = jswing.swing_ref(jnp.asarray(p0), jnp.asarray(p1), 0.1,
                             jnp.asarray(tau), jnp.asarray(dur))
    out_t = tswing.swing_ref(T(p0), T(p1), 0.1, T(tau), T(dur))
    for a, b in zip(out_t, out_j):
        close(a, b, 1e-12)


def test_disturbance_matches_jax(rng):
    sched = np.array(jdist.random_pushes(np.random.default_rng(5), 4.0,
                                         n=3, batch=B, dtype=jnp.float64,
                                         p_leg=0.5))
    sched_t = tdist.random_pushes(np.random.default_rng(5), 4.0, n=3,
                                  batch=B, dtype=torch.float64, p_leg=0.5)
    np.testing.assert_array_equal(sched_t.numpy(), sched)
    sched[0, 0, 5:7] = (3.0, 0.4)                   # one sinusoidal row
    t = sched[:, 0, 0] + 0.1
    fb, ff = jv(jdist.eval_links)(jnp.asarray(sched), jnp.asarray(t))
    fb_t, ff_t = tdist.eval_links(T(sched), T(t))
    close(fb_t, fb, 1e-12)
    close(ff_t, ff, 1e-12)
    close(tdist.eval_at(T(sched), T(t)),
          jv(jdist.eval_at)(jnp.asarray(sched), jnp.asarray(t)), 1e-12)
    # the schedule builders
    events = [(0.1, 0.3, 5.0, -2.0, 1.0), (0.2, 0.4, 1.0, 2.0, 3.0, 2)]
    f64, jf64 = dict(dtype=torch.float64), dict(dtype=jnp.float64)
    close(tdist.impulses(events, **f64), jdist.impulses(events, **jf64), 0)
    close(tdist.sinusoidal((1.0, 2.0, 0.0), 3.0, phase=0.5, link=1, **f64),
          jdist.sinusoidal((1.0, 2.0, 0.0), 3.0, phase=0.5, link=1, **jf64),
          0)
    close(tdist.leg_push(2, (1.0, 0.0, 0.0), 0.5, 0.8, **f64),
          jdist.leg_push(2, (1.0, 0.0, 0.0), 0.5, 0.8, **jf64), 0)
    close(tdist.empty(**f64), jdist.empty(**jf64), 0)


# ---------------------------------------------------------------------------
# kinematics, rigid-body dynamics, observer
# ---------------------------------------------------------------------------

def test_kinematics_match_jax(rng):
    p, R, q, u = state(rng)
    qd = u[:, 6:]
    r = ROBOT
    close(tkin.fk(r, T(q)), jv(lambda a: jkin.fk(r, a))(q), 1e-12)
    close(tkin.jacobians(r, T(q)),
          jv(lambda a: jkin.jacobians(r, a))(q), 1e-12)
    close(tkin.jdot_qd(r, T(q), T(qd)),
          jv(lambda a, b: jkin.jdot_qd(r, a, b))(q, qd), 1e-10)
    close(tkin.leg_jacobian(r, 2, T(q[:, 6:9])),
          jv(lambda a: jkin.leg_jacobian(r, 2, a))(q[:, 6:9]), 1e-12)
    signs = np.asarray(tdog.LEG_SIGNS, np.float64)[[0, 1, 3]]
    hips = jkin.hip_positions_static(r)[[0, 1, 3]]
    np.testing.assert_array_equal(tkin.hip_positions_static(r),
                                  jkin.hip_positions_static(r))
    close(tkin.leg_fk(r, T(signs), T(hips), T(q[:, 0:3])),
          jkin.leg_fk(r, jnp.asarray(signs), jnp.asarray(hips),
                      jnp.asarray(q[:, 0:3])), 1e-12)
    com = p + 0.01
    close(tkin.contact_jacobian(r, T(q), T(R), T(com), T(p)),
          jv(lambda a, b, c, d: jkin.contact_jacobian(r, a, b, c, d))(
              q, R, com, p), 1e-12)
    stance = tdog.nominal_stance(r)
    close(tkin.stance_ik(r, stance), jkin.stance_ik(r, stance), 1e-12)


def test_rbd_matches_jax(rng):
    p, R, q, u = state(rng)
    r = ROBOT
    Tp, TR, Tq, Tu = T(p), T(R), T(q), T(u)
    v = jv
    close(trbd.mass_matrix(r, TR, Tq),
          v(lambda a, b: jrbd.mass_matrix(r, a, b))(R, q), 1e-10)
    close(trbd.bias_forces(r, Tp, TR, Tq, Tu),
          v(lambda a, b, c, d: jrbd.bias_forces(r, a, b, c, d))(p, R, q, u),
          1e-10)
    M, h = trbd.mass_and_bias(r, Tp, TR, Tq, Tu)
    assert torch.equal(M, trbd.mass_matrix(r, TR, Tq))
    assert torch.equal(h, trbd.bias_forces(r, Tp, TR, Tq, Tu))
    close(trbd.contact_jacobian_mixed(r, Tp, TR, Tq),
          v(lambda a, b, c: jrbd.contact_jacobian_mixed(r, a, b, c))(p, R, q),
          1e-12)
    close(trbd.contact_bias_mixed(r, Tp, TR, Tq, Tu),
          v(lambda a, b, c, d: jrbd.contact_bias_mixed(r, a, b, c, d))(
              p, R, q, u), 1e-10)
    close(trbd.com_position(r, Tp, TR, Tq),
          v(lambda a, b, c: jrbd.com_position(r, a, b, c))(p, R, q), 1e-12)
    close(trbd.composite_inertia_com(r, Tp, TR, Tq),
          v(lambda a, b, c: jrbd.composite_inertia_com(r, a, b, c))(p, R, q),
          1e-12)
    close(trbd.com_jacobian(r, TR, Tq),
          v(lambda a, b: jrbd.com_jacobian(r, a, b))(R, q), 1e-12)
    assert trbd.total_mass(r) == jrbd.total_mass(r)


def test_observer_matches_jax(rng):
    p, R, q, u = state(rng)
    close(tobs.mdot_u(CFG, T(R), T(q), T(u)),
          jv(lambda a, b, c: jobs.mdot_u(JCFG, a, b, c))(R, q, u), 1e-10)
    for a, b in zip(tobs.init(CFG, T(p), T(R), T(q), T(u)),
                    jv(lambda a, b, c, d: jobs.init(JCFG, a, b, c, d))(
                        p, R, q, u)):
        close(a, b, 1e-10)
    y, w, p0 = rng.normal(size=(3, B, 6))
    forces = rng.normal(size=(B, 4, 3)) * 50.0
    jst = jobs.ObserverState(y_int=jnp.asarray(y), w=jnp.asarray(w),
                             p0=jnp.asarray(p0))
    out_j = jv(lambda s, a, b, c, d, f: jobs.update(
        JCFG, s, a, b, c, d, f, 0.0025, 10.0))(jst, p, R, q, u, forces)
    out_t = tobs.update(CFG, tobs.ObserverState(T(y), T(w), T(p0)), T(p),
                        T(R), T(q), T(u), T(forces), 0.0025, 10.0)
    for a, b in zip(out_t, out_j):
        close(a, b, 1e-10)


# ---------------------------------------------------------------------------
# terrain, APF, foothold selection
# ---------------------------------------------------------------------------

def test_terrain_sampling_matches_jax(rng):
    jt, tt = slope_terrain()
    xy = rng.uniform(-3.5, 3.5, (B, 7, 2))
    one = lambda fn: jv(lambda m, h, x: fn(  # noqa: E731
        jt._replace(mu_map=m, h_map=h), x))(jt.mu_map, jt.h_map, xy)
    close(tterr.sample_mu(tt, T(xy)), one(jterr.sample_mu), 0)
    close(tterr.sample_height(tt, T(xy)), one(jterr.sample_height), 1e-12)
    close(tterr.sample_normal(tt, T(xy)), one(jterr.sample_normal), 1e-12)
    close(tterr.cone_basis(tt, T(xy)), one(jterr.cone_basis), 1e-12)
    flat_t = tterr.flat(CFG.sim, batch=(B,), dtype=torch.float64)
    close(tterr.cone_basis(flat_t, T(xy)),
          np.broadcast_to(np.eye(3), (B, 7, 3, 3)), 0)
    # the numpy world builders give the JAX module's arrays
    for case in (1, 2, 5):
        close(tterr.case_world(CFG.sim, case, dtype=torch.float64).mu_map,
              jterr.case_world(CFG.sim, case, dtype=jnp.float64).mu_map, 0)
    for name, fn in tterr.HEIGHT_WORLDS.items():
        close(fn(CFG.sim, dtype=torch.float64).h_map,
              jterr.HEIGHT_WORLDS[name](CFG.sim, dtype=jnp.float64).h_map, 0)
    close(tterr.random_patches(CFG.sim, np.random.default_rng(1), batch=2,
                               dtype=torch.float64).mu_map,
          jterr.random_patches(CFG.sim, np.random.default_rng(1), batch=2,
                               dtype=jnp.float64).mu_map, 0)


@pytest.mark.parametrize("min_exit", [False, True])
def test_apf_matches_jax(rng, min_exit):
    acfg = ApfConfig(min_exit=min_exit, rep_field_in_step=True)
    rob = rng.uniform(0.0, 0.6, (B, 4))
    h_int = rng.uniform(0.0, 0.2, (B, 4))
    period = rng.uniform(0.3, 0.6, B)
    feet = (rng.normal(size=(B, 4, 2)) * 0.05
            + tdog.nominal_stance(ROBOT)[:, 0:2])
    com = rng.normal(size=(B, 2)) * 0.02
    target = rng.uniform(-1.0, 2.0, (B, 2))
    jst = japf.ApfState(jnp.asarray(rob), jnp.asarray(h_int),
                        jnp.asarray(period))
    tst = tapf.ApfState(T(rob), T(h_int), T(period))
    ju = japf.update_robustness(acfg, jst)
    tu = tapf.update_robustness(acfg, tst)
    for a, b in zip(tu, ju):
        close(a, b, 1e-12)
    for robot in (None, ROBOT):
        out_j = japf.navigate(acfg, ju, jnp.asarray(feet), jnp.asarray(com),
                              jnp.asarray(target), robot=robot)
        out_t = tapf.navigate(acfg, tu, T(feet), T(com), T(target),
                              robot=robot)
        for a, b in zip(out_t, out_j):
            close(a, b, 1e-12)
    forces = rng.normal(size=(B, 4, 3)) * 20.0 + np.array([0, 0, 40.0])
    forces[0, 1] = 0.0                                # an unloaded foot
    out_j = japf.accumulate_margin(acfg, jst, jnp.asarray(forces),
                                   jnp.asarray(0.0025))
    out_t = tapf.accumulate_margin(acfg, tst, T(forces), 0.0025)
    for a, b in zip(out_t, out_j):
        close(a, b, 1e-12)


def test_foothold_matches_jax(rng):
    cfg = CFG.sim
    jt = jterr.random_patches(cfg, np.random.default_rng(2), n_patches=8,
                              area=1.5, batch=B, dtype=jnp.float64)
    tt = tterr.random_patches(cfg, np.random.default_rng(2), n_patches=8,
                              area=1.5, batch=B, dtype=torch.float64)
    com = rng.uniform(-0.3, 1.0, (B, 2))
    step = (com[:, None, :] + tdog.nominal_stance(ROBOT)[:, 0:2]
            + rng.normal(size=(B, 4, 2)) * 0.05)
    out_j = jv(lambda m, s, c: jfoot.optimize(
        JCFG.foothold, ROBOT, jt._replace(mu_map=m), s, c))(
            jt.mu_map, jnp.asarray(step), jnp.asarray(com))
    close(tfoot.optimize(CFG.foothold, ROBOT, tt, T(step), T(com)), out_j, 0)
    close(tfoot.candidate_grid(CFG.foothold, ROBOT, dtype=torch.float64),
          jfoot.candidate_grid(JCFG.foothold, ROBOT, dtype=jnp.float64), 0)
    js, ts = slope_terrain()
    out_j = jv(lambda m, h, s, c: jfoot.optimize(
        JCFG.foothold, ROBOT, js._replace(mu_map=m, h_map=h), s, c))(
            js.mu_map, js.h_map, jnp.asarray(step), jnp.asarray(com))
    close(tfoot.optimize(CFG.foothold, ROBOT, ts, T(step), T(com)), out_j,
          1e-12)


def test_convert_carries_jax_state():
    """The JAX package's LoopState (vmapped init), Terrain and Scenario
    carried into the port equal the port's own init and generator."""
    from apf_quadruped_tpu.runtime import loop as jloop
    from apf_quadruped_tpu.runtime import sweep as jsweep
    from apf_quadruped_tpu_torch.runtime import loop as tloop
    from apf_quadruped_tpu_torch.runtime import sweep as tsweep

    jst = jax.vmap(lambda _: jloop.init(JCFG, dtype=jnp.float64))(
        jnp.arange(B))
    carried = convert.loop_state(jst)
    own = tloop.init(CFG, B, dtype=torch.float64, device="cpu")
    for a, b in zip(convert.to_numpy(carried.sim), convert.to_numpy(own.sim)):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-12)
    for f in ("apf", "obs"):
        for a, b in zip(getattr(carried, f), getattr(own, f)):
            assert torch.equal(a, b)
    for f in ("cycle_idx", "crawling", "warm_u", "warm_z", "warm_valid",
              "warm_flag"):
        assert torch.equal(getattr(carried, f), getattr(own, f)), f
    jt = jterr.case_world(JCFG.sim, 2, dtype=jnp.float64)
    tt = convert.terrain(jt)
    assert (tt.extent, tt.res, tt.h_map) == (jt.extent, jt.res, None)
    close(tt.mu_map, jt.mu_map, 0)
    scn_j = jsweep.random_scenarios(JCFG, 2, seed=3, dtype=jnp.float64,
                                    use_native=False)
    scn_t = tsweep.random_scenarios(CFG, 2, seed=3, dtype=torch.float64,
                                    use_native=False, device="cpu")
    for a, b in zip(convert.scenario(scn_j), scn_t):
        # h_map: flat ground on both sides
        assert (a is None and b is None) or torch.equal(a, b)
