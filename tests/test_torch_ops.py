"""The port's rotations, SRB model and gait schedule vs the JAX package.

Each function of apf_quadruped_tpu_torch gets the same numpy inputs as its
apf_quadruped_tpu counterpart, in an explicit dtype on both sides.
Tolerances: float64 atol 1e-12, float32 atol 1e-6 (one or two roundings of
O(1) values; the contraction order of einsum differs between the two
frameworks).  The gait schedule is compared exactly.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apf_quadruped_tpu import gait as jgait
from apf_quadruped_tpu.models import srb as jsrb
from apf_quadruped_tpu.ops import rotations as jrot
from apf_quadruped_tpu_torch import gait as tgait
from apf_quadruped_tpu_torch.config import EngineConfig, RobotConfig
from apf_quadruped_tpu_torch.models import srb as tsrb
from apf_quadruped_tpu_torch.ops import rotations as trot

torch.set_num_threads(1)

DTYPES = [(np.float32, 1e-6), (np.float64, 1e-12)]


def _both(fn_name, module_j, module_t, *args):
    """Call fn_name in both packages on the same numpy args."""
    out_j = getattr(module_j, fn_name)(*[jnp.asarray(a) for a in args])
    out_t = getattr(module_t, fn_name)(*[torch.as_tensor(a) for a in args])
    return out_j, out_t


def _assert_close(out_j, out_t, atol, dtype):
    if isinstance(out_t, tuple):
        assert len(out_j) == len(out_t)
        for a, b in zip(out_j, out_t):
            _assert_close(a, b, atol, dtype)
        return
    assert out_t.dtype == torch.from_numpy(np.zeros(0, dtype)).dtype
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j), rtol=0,
                               atol=atol)


@pytest.mark.parametrize("dtype,atol", DTYPES)
@pytest.mark.parametrize("fn_name,shape", [
    ("skew", (5, 3)), ("rot_x", (5,)), ("rot_y", (5,)), ("rot_z", (5,)),
    ("rpy_to_rot", (2, 5, 3)), ("euler_rate_to_omega_world", (5, 3)),
    ("omega_world_to_euler_rate", (5, 3)), ("inertia_tensor", (5, 6))])
def test_rotations_match_jax(rng, fn_name, shape, dtype, atol):
    x = rng.uniform(-1.2, 1.2, shape).astype(dtype)
    out_j, out_t = _both(fn_name, jrot, trot, x)
    _assert_close(out_j, out_t, atol, dtype)


@pytest.mark.parametrize("dtype,atol", DTYPES)
def test_rot_to_rpy_matches_jax(rng, dtype, atol):
    rpy = rng.uniform(-1.2, 1.2, (7, 3)).astype(dtype)
    R = np.asarray(jrot.rpy_to_rot(jnp.asarray(rpy)))
    out_j, out_t = _both("rot_to_rpy", jrot, trot, R)
    _assert_close(out_j, out_t, atol, dtype)
    np.testing.assert_allclose(out_t.numpy(), rpy, atol=max(atol, 1e-5))


def _srb_inputs(rng, dtype, batch=(3, 4)):
    return dict(
        rpy=rng.uniform(-0.3, 0.3, batch + (3,)),
        r=rng.normal(size=batch + (3,)) * 0.1 + [0.0, 0.0, 0.4],
        omega=rng.normal(size=batch + (3,)),
        v=rng.normal(size=batch + (3,)),
        feet_w=rng.normal(size=batch + (4, 3)) * 0.3,
        forces=rng.normal(size=batch + (4, 3)) * 50.0,
        contact=(rng.uniform(size=batch + (4,)) < 0.6).astype(float),
    ) | {"dtype": dtype}


@pytest.mark.parametrize("dtype,atol", DTYPES)
def test_srb_pack_unpack_match_jax(rng, dtype, atol):
    d = _srb_inputs(rng, dtype)
    args = [d[k].astype(dtype) for k in ("rpy", "r", "omega", "v")]
    x_j, x_t = _both("pack_state", jsrb, tsrb, *args)
    _assert_close(x_j, x_t, 0.0, dtype)
    u_j, u_t = _both("unpack_state", jsrb, tsrb, np.asarray(x_j))
    _assert_close(u_j, u_t, 0.0, dtype)


@pytest.mark.parametrize("dtype,atol", DTYPES)
def test_srb_linearize_discrete_matches_jax(rng, dtype, atol):
    d = _srb_inputs(rng, dtype)
    cfg = RobotConfig()
    yaw = d["rpy"][..., 2].astype(dtype)
    args = [d[k].astype(dtype) for k in ("r", "feet_w", "contact")]
    A_j, B_j = jsrb.linearize_discrete(
        cfg, jnp.asarray(yaw), *map(jnp.asarray, args), 0.025)
    A_t, B_t = tsrb.linearize_discrete(
        cfg, torch.as_tensor(yaw), *map(torch.as_tensor, args), 0.025)
    assert A_t.shape == (3, 4, tsrb.NX, tsrb.NX) and B_t.shape == (3, 4, 13, 12)
    _assert_close((A_j, B_j), (A_t, B_t), atol, dtype)


@pytest.mark.parametrize("dtype,atol", DTYPES)
def test_srb_derivative_matches_jax(rng, dtype, atol):
    d = _srb_inputs(rng, dtype)
    cfg = RobotConfig()
    args = [d[k].astype(dtype)
            for k in ("rpy", "r", "omega", "v", "feet_w", "forces")]
    out_j = jsrb.srb_derivative(cfg, *map(jnp.asarray, args))
    out_t = tsrb.srb_derivative(cfg, *map(torch.as_tensor, args))
    # the accelerations are O(10-100): scale the absolute tolerance
    _assert_close(out_j, out_t, atol * 100, dtype)


def test_gait_tables_equal_jax():
    for field in ("durations", "contacts", "n_phases"):
        np.testing.assert_array_equal(getattr(tgait._TABLE, field),
                                      getattr(jgait._TABLE, field))
    assert tgait.STRIDES == jgait.STRIDES
    assert tgait.GAIT_FLAG_COMBOS == jgait.GAIT_FLAG_COMBOS
    assert tgait.NAMED_MODE_FLAGS == jgait.NAMED_MODE_FLAGS


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_horizon_contacts_equal_jax_every_flag(rng, dtype):
    """Exactly equal stance schedules for every gait flag, over phases
    that start anywhere in the cycle and cycles of several lengths."""
    flags = np.repeat(np.arange(jgait.NUM_GAITS), 6).astype(np.int32)
    t0 = rng.uniform(0.0, 1.2, flags.shape).astype(dtype)
    cycle = rng.choice([0.5, 0.75, 1.0], flags.shape).astype(dtype)
    cfg = EngineConfig()
    for H in (cfg.mpc.horizon, 40):
        jdt = jnp.float32 if dtype == np.float32 else jnp.float64
        tdt = torch.float32 if dtype == np.float32 else torch.float64
        c_j = jgait.horizon_contacts(jnp.asarray(flags), jnp.asarray(t0),
                                     cfg.mpc.dt, H, jnp.asarray(cycle),
                                     dtype=jdt)
        c_t = tgait.horizon_contacts(torch.as_tensor(flags),
                                     torch.as_tensor(t0), cfg.mpc.dt, H,
                                     torch.as_tensor(cycle), dtype=tdt)
        assert c_t.shape == (flags.shape[0], H, 4) and c_t.dtype == tdt
        np.testing.assert_array_equal(c_t.numpy(), np.asarray(c_j))


def test_contact_state_equal_jax(rng):
    flags = rng.integers(0, jgait.NUM_GAITS, (5, 7)).astype(np.int32)
    t = rng.uniform(0.0, 1.1, (5, 7)).astype(np.float32)
    cycle = np.full((5, 7), 0.5, np.float32)
    c_j = jgait.contact_state(*map(jnp.asarray, (flags, t, cycle)))
    c_t = tgait.contact_state(*map(torch.as_tensor, (flags, t, cycle)))
    np.testing.assert_array_equal(c_t.numpy(), np.asarray(c_j))
