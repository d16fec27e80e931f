"""The zoo robots (models/zoo.py) through the port vs the JAX package, on
the CPU, in float64.

  * the leg chains of anymal and hyq: kinematics (fk, stance_ik) and the
    rigid-body dynamics (mass matrix, bias forces, contact Jacobian) at
    1e-12, as the port's closed forms against the JAX package's autodiff;
  * the SRB planner standing each towr model (tests/test_zoo.py: the
    quadrupeds, the monoped on one foot, the biped on two) against the
    JAX planner: converged and iters exactly, forces within 1e-6 of the
    largest (two float64 runs of one interior point, summed in another
    order).

Their closed loops are held to the JAX package in
tests/test_torch_zoo_loop.py.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apf_quadruped_tpu import planner as jplanner
from apf_quadruped_tpu.config import (EngineConfig as JEngineConfig,
                                      MpcConfig as JMpcConfig,
                                      SolverConfig as JSolverConfig)
from apf_quadruped_tpu.models import kinematics as jkin
from apf_quadruped_tpu.models import rbd as jrbd
from apf_quadruped_tpu.models import srb as jsrb
from apf_quadruped_tpu.models import zoo as jzoo
from apf_quadruped_tpu.ops.rotations import rpy_to_rot
from apf_quadruped_tpu_torch import convert, planner
from apf_quadruped_tpu_torch.config import EngineConfig, MpcConfig, SolverConfig
from apf_quadruped_tpu_torch.models import dogbot as tdog
from apf_quadruped_tpu_torch.models import kinematics as tkin
from apf_quadruped_tpu_torch.models import rbd as trbd
from apf_quadruped_tpu_torch.models import srb, zoo

torch.set_num_threads(1)

SOLVER = SolverConfig(iters=25, reltol=1e-6, abstol=1e-4)
B = 3


def T(a):
    return torch.as_tensor(np.array(a))


def close(port, ref, atol):
    np.testing.assert_allclose(convert.to_numpy(port), np.asarray(ref),
                               rtol=0, atol=atol)


def _state(rng, robot):
    """Random states around the robot's nominal stance: (p, R, q, u)."""
    q0 = tdog.default_joint_angles(robot).numpy()
    q = q0 + rng.normal(size=(B, 12)) * 0.1
    u = rng.normal(size=(B, 18)) * 0.5
    p = (np.array([0.0, 0.0, robot.com_height])
         + rng.normal(size=(B, 3)) * 0.02)
    R = np.asarray(jax.vmap(rpy_to_rot)(jnp.asarray(
        rng.normal(size=(B, 3)) * 0.1)))
    return p, R, q, u


@pytest.mark.parametrize("name", ["anymal", "hyq"])
def test_leg_chain_matches_jax(rng, name):
    robot = zoo.robot_config_for(zoo.ZOO[name]())
    jrobot = jzoo.robot_config_for(jzoo.ZOO[name]())
    assert dataclasses.asdict(robot) == dataclasses.asdict(jrobot)
    stance = tdog.nominal_stance(robot)
    q_ik = tkin.stance_ik(robot, stance)
    close(q_ik, jkin.stance_ik(jrobot, stance), 1e-12)
    close(tkin.fk(robot, q_ik), stance, 1e-9)
    p, R, q, u = _state(rng, robot)
    v = lambda fn: jax.jit(jax.vmap(fn))  # noqa: E731
    close(tkin.fk(robot, T(q)), v(lambda a: jkin.fk(jrobot, a))(q), 1e-12)
    close(trbd.mass_matrix(robot, T(R), T(q)),
          v(lambda a, b: jrbd.mass_matrix(jrobot, a, b))(R, q), 1e-12)
    close(trbd.bias_forces(robot, T(p), T(R), T(q), T(u)),
          v(lambda a, b, c, d: jrbd.bias_forces(jrobot, a, b, c, d))(
              p, R, q, u), 1e-12)
    close(trbd.contact_jacobian_mixed(robot, T(p), T(R), T(q)),
          v(lambda a, b, c: jrbd.contact_jacobian_mixed(jrobot, a, b, c))(
              p, R, q), 1e-12)
    assert abs(trbd.total_mass(robot) - robot.mass) < 2e-3


def _stand_refs(pkg, cfg, model):
    """tests/test_zoo.py's standing problem: (x0, refs), one scenario
    with a batch axis for the port."""
    H = cfg.mpc.horizon
    com0 = np.array([0.0, 0.0, model.com_height])
    feet0 = np.asarray(model.nominal_stance) + com0
    feet0[:, 2] = 0.0
    contacts = np.tile(np.asarray(model.foot_mask), (H, 1))
    if pkg is jplanner:
        a = jnp.asarray
        cyc, yaw = a(H * cfg.mpc.dt), a(0.0)
        x0 = jsrb.pack_state(a(np.zeros(3)), a(com0), a(np.zeros(3)),
                             a(np.zeros(3)))
    else:
        def a(x):
            return T(x)[None]
        cyc, yaw = T([H * cfg.mpc.dt]), T([0.0])
        x0 = srb.pack_state(a(np.zeros(3)), a(com0), a(np.zeros(3)),
                            a(np.zeros(3)))
    refs = pkg.MpcRefs(
        contacts=a(contacts),
        feet_w=pkg.foothold_schedule(a(feet0), a(feet0), a(contacts)),
        x_ref=pkg.reference_trajectory(cfg, a(np.zeros(3)), a(com0),
                                       a(com0), yaw, cyc),
        yaw_ref=yaw)
    return x0, refs


@pytest.mark.parametrize("name", ["anymal", "hyq", "monoped", "biped"])
def test_srb_planner_stands_like_jax(name):
    model, jmodel = zoo.ZOO[name](), jzoo.ZOO[name]()
    mpc = dict(horizon=10, dt=0.05)
    cfg = EngineConfig(robot=zoo.robot_config_for(model),
                       mpc=MpcConfig(**mpc), solver=SOLVER)
    jcfg = JEngineConfig(robot=jzoo.robot_config_for(jmodel),
                         mpc=JMpcConfig(**mpc),
                         solver=JSolverConfig(**dataclasses.asdict(SOLVER)))
    jout = jplanner.plan(jcfg, *_stand_refs(jplanner, jcfg, jmodel))
    out = planner.plan(cfg, *_stand_refs(planner, cfg, model))
    assert bool(out.sol.converged[0]) and bool(jout.sol.converged)
    assert int(out.sol.iters[0]) == int(jout.sol.iters)
    f, jf = out.forces[0].numpy(), np.asarray(jout.forces)
    np.testing.assert_allclose(f, jf, rtol=0,
                               atol=1e-6 * max(1.0, np.abs(jf).max()))
    weight = model.mass * srb.GRAVITY
    if name in ("anymal", "hyq"):
        np.testing.assert_allclose(f[:-2, :, 2], weight / 4, rtol=0.08)
    else:
        n = int(model.foot_mask.sum())
        np.testing.assert_allclose(f[:-1, :n, 2].sum(-1), weight, rtol=0.05)
        np.testing.assert_allclose(f[:, n:], 0.0, atol=1e-6)


def test_zoo_registry():
    assert set(zoo.ZOO) == set(jzoo.ZOO) == {"dogbot", "anymal", "hyq",
                                             "biped", "monoped"}
    assert abs(zoo.ZOO["anymal"]().mass - 29.5) < 1e-9
