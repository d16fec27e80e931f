"""Rotation / Euler-angle utilities (ZYX convention).

Port of apf_quadruped_tpu/ops/rotations.py: mappings between ZYX Euler
angles (stored as [roll, pitch, yaw]) and rotation matrices, and between
Euler rates and angular velocity.  Every function takes tensors with any
leading batch dims and returns the dtype and device of its input.
"""

from __future__ import annotations

import torch


def _mat3(rows) -> torch.Tensor:
    """3x3 from nested lists of equally-shaped tensors -> (..., 3, 3)."""
    return torch.stack([e for r in rows for e in r], dim=-1).unflatten(
        -1, (3, 3))


def skew(v: torch.Tensor) -> torch.Tensor:
    """Cross-product matrix: skew(v) @ u == cross(v, u). v: (..., 3)."""
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    zero = torch.zeros_like(x)
    return _mat3([[zero, -z, y], [z, zero, -x], [-y, x, zero]])


def rot_x(a: torch.Tensor) -> torch.Tensor:
    c, s = torch.cos(a), torch.sin(a)
    o, z = torch.ones_like(a), torch.zeros_like(a)
    return _mat3([[o, z, z], [z, c, -s], [z, s, c]])


def rot_y(a: torch.Tensor) -> torch.Tensor:
    c, s = torch.cos(a), torch.sin(a)
    o, z = torch.ones_like(a), torch.zeros_like(a)
    return _mat3([[c, z, s], [z, o, z], [-s, z, c]])


def rot_z(a: torch.Tensor) -> torch.Tensor:
    c, s = torch.cos(a), torch.sin(a)
    o, z = torch.ones_like(a), torch.zeros_like(a)
    return _mat3([[c, -s, z], [s, c, z], [z, z, o]])


def rpy_to_rot(rpy: torch.Tensor) -> torch.Tensor:
    """ZYX Euler [roll, pitch, yaw] -> world_R_base. (..., 3) -> (..., 3, 3)."""
    return rot_z(rpy[..., 2]) @ rot_y(rpy[..., 1]) @ rot_x(rpy[..., 0])


def rot_to_rpy(R: torch.Tensor) -> torch.Tensor:
    """Inverse of rpy_to_rot (pitch in (-pi/2, pi/2))."""
    pitch = torch.arcsin(-torch.clamp(R[..., 2, 0], -1.0, 1.0))
    roll = torch.atan2(R[..., 2, 1], R[..., 2, 2])
    yaw = torch.atan2(R[..., 1, 0], R[..., 0, 0])
    return torch.stack([roll, pitch, yaw], dim=-1)


def euler_rate_to_omega_world(rpy: torch.Tensor) -> torch.Tensor:
    """Matrix E(rpy) with omega_world = E @ d(rpy)/dt (ZYX convention)."""
    p, y = rpy[..., 1], rpy[..., 2]
    cy, sy = torch.cos(y), torch.sin(y)
    cp, sp = torch.cos(p), torch.sin(p)
    zero, one = torch.zeros_like(p), torch.ones_like(p)
    # columns: [d/droll, d/dpitch, d/dyaw]
    return _mat3([[cp * cy, -sy, zero], [cp * sy, cy, zero],
                  [-sp, zero, one]])


def omega_world_to_euler_rate(rpy: torch.Tensor) -> torch.Tensor:
    """Inverse mapping d(rpy)/dt = Einv @ omega_world (valid |pitch| < pi/2)."""
    p, y = rpy[..., 1], rpy[..., 2]
    cy, sy = torch.cos(y), torch.sin(y)
    cp, sp = torch.cos(p), torch.sin(p)
    tp = sp / cp
    zero, one = torch.zeros_like(p), torch.ones_like(p)
    return _mat3([[cy / cp, sy / cp, zero], [-sy, cy, zero],
                  [cy * tp, sy * tp, one]])


def inertia_tensor(inertia6: torch.Tensor) -> torch.Tensor:
    """(Ixx, Iyy, Izz, Ixy, Ixz, Iyz) -> symmetric 3x3."""
    ixx, iyy, izz, ixy, ixz, iyz = (inertia6[..., i] for i in range(6))
    return _mat3([[ixx, ixy, ixz], [ixy, iyy, iyz], [ixz, iyz, izz]])
