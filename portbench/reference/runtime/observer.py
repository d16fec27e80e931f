"""Momentum-based external-wrench observer.

Port of apf_quadruped_tpu/runtime/observer.py: a first-order residual
observer on the 6D floating-base momentum,

    y_int += ((Jc' f + Mdot u)[0:6] - h[0:6] + w) dt
    w      = K ((M u)[0:6] - y_int - p0)

run every tracking tick against the WBC's own M, h, Jc.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..config import EngineConfig
from ..models import rbd


class ObserverState(NamedTuple):
    y_int: torch.Tensor   # (.., 6) integral of known generalized force + w
    w: torch.Tensor       # (.., 6) current external-wrench estimate
    p0: torch.Tensor      # (.., 6) initial momentum offset


def _mv(M, v):
    return (M @ v.unsqueeze(-1)).squeeze(-1)


def init(cfg: EngineConfig, p_base, R_wb, q, u) -> ObserverState:
    p = _mv(rbd.mass_matrix(cfg.robot, R_wb, q), u)[..., 0:6]
    z = torch.zeros_like(p)
    return ObserverState(y_int=z, w=z, p0=p)


def update(cfg: EngineConfig, st: ObserverState, p_base, R_wb, q, u,
           contact_forces, dt, gain: float = 0.5) -> ObserverState:
    """One observer tick evaluating the dynamics itself; contact_forces
    (.., 4, 3) world forces at the feet."""
    M, h = rbd.mass_and_bias(cfg.robot, p_base, R_wb, q, u)
    Jc = rbd.contact_jacobian_mixed(cfg.robot, p_base, R_wb, q)
    return update_from_dyn(st, M, h, Jc, u, contact_forces, dt, gain,
                           mdot_u=mdot_u(cfg, R_wb, q, u))


def mdot_u(cfg: EngineConfig, R_wb, q, u):
    """(.., 18) Mdot @ u, the convective momentum term: the rate of the mass
    matrix along the state velocity (Rdot = skew(omega) R, qdot = u[6:18])
    times u.  The JAX module takes one jvp of the mass matrix; the port
    has it in closed form (models/rbd.mdot_u)."""
    return rbd.mdot_u(cfg.robot, R_wb, q, u)


def update_from_dyn(st: ObserverState, M, h, Jc, u, contact_forces, dt,
                    gain, mdot_u) -> ObserverState:
    """Observer tick against already-evaluated dynamics (M, h, Jc); `u` is
    the velocity after the physics step whose substep-averaged contact
    forces are passed."""
    p = _mv(M, u)[..., 0:6]
    f = contact_forces.reshape(contact_forces.shape[:-2] + (12,))
    known = ((f.unsqueeze(-2) @ Jc).squeeze(-2) - h + mdot_u)[..., 0:6]
    y_int = st.y_int + (known + st.w) * dt
    return ObserverState(y_int=y_int, w=gain * (p - y_int - st.p0), p0=st.p0)
