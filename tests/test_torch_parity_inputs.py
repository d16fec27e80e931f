"""Shared inputs and comparisons of the port-vs-JAX parity tests of the
closed loop (tests/test_torch_loop_parts.py, test_torch_qp_parts.py,
test_torch_wbc_physics.py): float64 numpy inputs from a seed go through the
JAX function, vmapped over a batch of 3 and compiled, and through the
port.  The one test here holds the shared inputs to what the other files
assume of them."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from apf_quadruped_tpu.config import (EngineConfig as JEngineConfig,
                                      WbcConfig as JWbcConfig)
from apf_quadruped_tpu.ops.rotations import rpy_to_rot
from apf_quadruped_tpu.sim import terrain as jterr
from apf_quadruped_tpu_torch import convert
from apf_quadruped_tpu_torch.config import EngineConfig, WbcConfig
from apf_quadruped_tpu_torch.models import dogbot as tdog
from apf_quadruped_tpu_torch.sim import terrain as tterr

B = 3
CFG = EngineConfig(wbc=WbcConfig(slack_weight_trot=1e6))
JCFG = JEngineConfig(wbc=JWbcConfig(slack_weight_trot=1e6))
ROBOT = CFG.robot


def T(a):
    return torch.as_tensor(np.array(a))


def jv(fn):
    """The JAX function vmapped over the batch, compiled."""
    return jax.jit(jax.vmap(fn))


def close(port, jax_out, atol, rtol=0.0):
    np.testing.assert_allclose(convert.to_numpy(port), np.asarray(jax_out),
                               rtol=rtol, atol=atol)


def state(rng, batch=B):
    """Random robot states around the crouched stance: (p, R, q, u)."""
    q0 = np.asarray(tdog.default_joint_angles(ROBOT))
    q = q0 + rng.normal(size=(batch, 12)) * 0.1
    u = rng.normal(size=(batch, 18)) * 0.5
    p = np.array([0.0, 0.0, 0.43]) + rng.normal(size=(batch, 3)) * 0.02
    rpy = rng.normal(size=(batch, 3)) * 0.1
    R = np.asarray(jv(rpy_to_rot)(jnp.asarray(rpy)))
    return p, R, q, u


def slope_terrain(batch=B):
    """A height world (towr Slope) with per-scenario mu maps, as the JAX
    package's Terrain and the port's."""
    cfg = CFG.sim.__class__(terrain_res=64, terrain_extent=3.0)
    jt = jterr.slope(cfg, dtype=jnp.float64)
    mu = np.asarray(jt.mu_map) * np.linspace(0.5, 1.0, batch)[:, None, None]
    return (jt._replace(mu_map=jnp.asarray(mu),
                        h_map=jnp.broadcast_to(jt.h_map, mu.shape)),
            tterr.Terrain(mu_map=T(mu), extent=jt.extent, res=jt.res,
                          h_map=T(np.broadcast_to(np.asarray(jt.h_map),
                                                  mu.shape))))


def test_shared_inputs(rng):
    """Both packages see one configuration and one terrain, and the random
    states are proper rotations around the crouched stance."""
    assert dataclasses.asdict(CFG) == dataclasses.asdict(JCFG)
    p, R, q, u = state(rng)
    assert p.shape == (B, 3) and q.shape == (B, 12) and u.shape == (B, 18)
    np.testing.assert_allclose(R @ R.transpose(0, 2, 1),
                               np.broadcast_to(np.eye(3), (B, 3, 3)),
                               atol=1e-12)
    np.testing.assert_allclose(np.linalg.det(R), 1.0, atol=1e-12)
    jt, tt = slope_terrain()
    assert (tt.extent, tt.res) == (jt.extent, jt.res)
    close(tt.mu_map, jt.mu_map, 0.0)
    close(tt.h_map, jt.h_map, 0.0)
    assert tt.mu_map.shape == (B, tt.res, tt.res)
