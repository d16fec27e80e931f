"""Single-rigid-body (centroidal) dynamics: continuous and linearized discrete.

Port of apf_quadruped_tpu/models/srb.py.  State layout (13):
x = [rpy(3), r(3), omega_world(3), v(3), 1]; the trailing 1 carries gravity
through the linear dynamics x_{k+1} = A_k x_k + B_k u_k.  Controls u (12)
are the stacked world-frame ground-reaction forces of (BR, BL, FL, FR).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .._device import constant
from ..config import RobotConfig
from ..ops.rotations import (inertia_tensor, omega_world_to_euler_rate,
                             rpy_to_rot, skew)

NX = 13   # state dim (12 + affine carrier)
NU = 12   # 4 legs x 3 force components
GRAVITY = 9.81


def srb_derivative(cfg: RobotConfig, rpy, r, omega, v, feet_w, forces):
    """Exact continuous SRB dynamics.

    rpy, r, omega, v: (.., 3); feet_w, forces: (.., 4, 3) world frame.
    Returns (rpy_dot, r_dot, omega_dot, v_dot).
    """
    R = rpy_to_rot(rpy)
    I_b = inertia_tensor(constant(cfg.inertia, rpy.dtype, rpy.device))
    I_w = R @ I_b @ R.transpose(-1, -2)
    f_tot = forces.sum(dim=-2)
    tau = torch.linalg.cross(feet_w - r[..., None, :], forces).sum(dim=-2)
    gyro = torch.linalg.cross(omega, (I_w @ omega[..., None])[..., 0])
    # solve_ex: linalg.solve's factorization without its host-side check
    omega_dot = torch.linalg.solve_ex(I_w, (tau - gyro)[..., None],
                                      check_errors=False)[0][..., 0]
    g = constant((0.0, 0.0, -GRAVITY), rpy.dtype, rpy.device)
    v_dot = f_tot / cfg.mass + g
    rpy_dot = (omega_world_to_euler_rate(rpy) @ omega[..., None])[..., 0]
    return rpy_dot, v, omega_dot, v_dot


def pack_state(rpy, r, omega, v):
    """(.., NX) with the affine carrier appended."""
    one = torch.ones(rpy.shape[:-1] + (1,), dtype=rpy.dtype, device=rpy.device)
    return torch.cat([rpy, r, omega, v, one], dim=-1)


def unpack_state(x):
    return x[..., 0:3], x[..., 3:6], x[..., 6:9], x[..., 9:12]


@functools.lru_cache(maxsize=None)
def _body_inertia_inv(cfg: RobotConfig, dtype, device) -> torch.Tensor:
    """I_b^-1 (3, 3), inverted in float64 on the host, then cast."""
    ixx, iyy, izz, ixy, ixz, iyz = cfg.inertia
    I_b = np.array([[ixx, ixy, ixz], [ixy, iyy, iyz], [ixz, iyz, izz]],
                   np.float64)
    return torch.as_tensor(np.linalg.inv(I_b), dtype=dtype, device=device)


def linearize_discrete(cfg: RobotConfig, yaw_ref, r_ref, feet_w, contact,
                       dt: float):
    """Per-knot forward-Euler linearization (A, B) of the SRB dynamics.

    yaw_ref (..,), r_ref (.., 3) reference CoM (torque lever arms),
    feet_w (.., 4, 3) footholds, contact (.., 4) 0/1 stance mask.
    Returns A (.., NX, NX), B (.., NX, NU).  I_w^-1 = R I_b^-1 R' with the
    constant I_b^-1 taken in float64 on the host, as the JAX package does.
    """
    dtype, device = r_ref.dtype, r_ref.device
    batch = yaw_ref.shape
    zero = torch.zeros_like(yaw_ref)
    rpy0 = torch.stack([zero, zero, yaw_ref], dim=-1)
    Einv = omega_world_to_euler_rate(rpy0)                 # (.., 3, 3)
    R = rpy_to_rot(rpy0)
    I_w_inv = torch.einsum("...ij,jk,...lk->...il", R,
                           _body_inertia_inv(cfg, dtype, device), R)

    dts = constant(dt, dtype, device)
    eye3 = torch.eye(3, dtype=dtype, device=device)
    A = torch.zeros(batch + (NX, NX), dtype=dtype, device=device)
    A.diagonal(dim1=-2, dim2=-1).fill_(1.0)
    A[..., 0:3, 6:9] = dts * Einv                          # rpy' = Einv w
    A[..., 3:6, 9:12] = dts * eye3                         # r' = v
    A[..., 11, 12] = -GRAVITY * dt                         # v' gravity

    # omega' blocks dt * I_w^-1 skew(lever_i) * contact_i side by side,
    # v' blocks dt/m * contact_i * I
    lever = feet_w - r_ref[..., None, :]                   # (.., 4, 3)
    wblk = dts * torch.einsum("...ij,...ljk->...lik", I_w_inv, skew(lever))
    wblk = wblk * contact[..., :, None, None]
    vblk = (dts / cfg.mass) * contact[..., :, None, None] * eye3
    B = torch.zeros(batch + (NX, NU), dtype=dtype, device=device)
    B[..., 6:9, :] = wblk.transpose(-3, -2).reshape(batch + (3, NU))
    B[..., 9:12, :] = vblk.transpose(-3, -2).reshape(batch + (3, NU))
    return A, B
