"""Swing-foot reference trajectories (closed-form splines).

Port of apf_quadruped_tpu/swing.py: a smoothstep cubic in xy (zero end
velocities) and a quartic lift-cruise-land profile in z, from the liftoff
foothold to the chosen target.  Elementwise in the phase tau in [0, 1];
position, velocity and acceleration are analytic.
"""

from __future__ import annotations

import torch


def _cubic_blend(tau):
    """s(tau) = 3 tau^2 - 2 tau^3 and its first two derivatives."""
    return (tau * tau * (3.0 - 2.0 * tau), 6.0 * tau * (1.0 - tau),
            6.0 - 12.0 * tau)


def _z_profile(tau):
    """z(tau) = 16 tau^2 (1 - tau)^2 (apex 1 at tau = 0.5) and its first
    two derivatives."""
    u = tau * (1.0 - tau)
    return (16.0 * u * u, 32.0 * u * (1.0 - 2.0 * tau),
            32.0 * ((1.0 - 2.0 * tau) ** 2 - 2.0 * u))


def _add_z(v, dz):
    return torch.cat([v[..., 0:2], v[..., 2:3] + dz[..., None]], dim=-1)


def swing_ref(p0, p1, height, tau, duration):
    """Swing reference at phase tau.

    p0, p1: (.., 3) liftoff / touchdown positions (world); height: scalar
    or (..,) apex above the chord; tau: (..,) phase; duration: (..,)
    seconds.  Returns (pos, vel, acc), each (.., 3), in real time units.
    """
    tau = torch.clamp(tau, 0.0, 1.0)
    s, ds, dds = _cubic_blend(tau)
    z, dz, ddz = _z_profile(tau)
    inv_T = 1.0 / torch.clamp(duration, min=1e-6)
    d = p1 - p0
    pos = _add_z(p0 + d * s[..., None], height * z)
    vel = _add_z(d * (ds * inv_T)[..., None], height * dz * inv_T)
    acc = _add_z(d * (dds * inv_T * inv_T)[..., None],
                 height * ddz * inv_T * inv_T)
    return pos, vel, acc
