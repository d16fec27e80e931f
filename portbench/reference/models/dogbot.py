"""DogBot v4 model data as numpy arrays (the port's copy of
apf_quadruped_tpu/models/dogbot.py; `default_joint_angles` goes through
the port's models/kinematics.py).

Derived from the reference robot description (dogbot.xacro) and the towr
model constants (include/towr/models/examples/dogbot_model.h) — the same
numbers the reference controller uses, re-expressed as arrays.

Conventions:
  * Leg order: ``LEGS = ("BR", "BL", "FL", "FR")`` — matches the row
    stacking of the reference's 12x18 linear contact Jacobian
    (reference main.cpp ctrl_loop: swing rows 0-2 = BR, stance rows 3-5 = BL,
    6-8 = FL, 9-11 = FR).
  * Base frame: +y forward (body long axis), +x right, +z up
    (dogbot.xacro:213 "front-right is 1,1").
  * Per-leg joints: (roll, pitch, knee); 12-vector layout is leg-major:
    ``q = [q_BR(3), q_BL(3), q_FL(3), q_FR(3)]``.
"""

from __future__ import annotations

import numpy as np

from ..config import RobotConfig

LEGS = ("BR", "BL", "FL", "FR")
NUM_LEGS = 4
# (sigma_x, sigma_y) per leg: sigma_x = right(+1)/left(-1), sigma_y = front(+1)/back(-1)
LEG_SIGNS = np.array(
    [
        [1.0, -1.0],   # BR
        [-1.0, -1.0],  # BL
        [-1.0, 1.0],   # FL
        [1.0, 1.0],    # FR
    ]
)


def nominal_stance(cfg: RobotConfig) -> np.ndarray:
    """(4, 3) nominal foot positions in the base frame.

    Matches towr's DogbotKinematicModel nominal stance (dogbot_model.h:55-81)
    and the APF goal offsets (main.cpp:1171-1174).
    """
    out = np.zeros((4, 3))
    out[:, 0] = LEG_SIGNS[:, 0] * cfg.stance_x
    out[:, 1] = LEG_SIGNS[:, 1] * cfg.stance_y
    out[:, 2] = cfg.stance_z
    return out


def hip_positions(cfg: RobotConfig) -> np.ndarray:
    """(4, 3) hip-roll joint origins in the base frame (dogbot.xacro:246)."""
    out = np.zeros((4, 3))
    out[:, 0] = LEG_SIGNS[:, 0] * cfg.hip_offset_side
    out[:, 1] = LEG_SIGNS[:, 1] * cfg.hip_offset
    return out


def repulsive_versors() -> np.ndarray:
    """(4, 2) outward unit vectors from body centre toward each foot's nominal
    stance (reference main.cpp:440-458): the direction the slippage-repulsive
    field pushes each foot."""
    v = LEG_SIGNS * np.array([0.186571, 0.289186])
    return v / np.linalg.norm(v, axis=-1, keepdims=True)


def joint_limits(cfg: RobotConfig) -> tuple[np.ndarray, np.ndarray]:
    """(12,), (12,) q_min / q_max in leg-major (roll, pitch, knee) layout.

    From the xacro limit formulas (dogbot.xacro:242-251 roll +/-100deg;
    286-297 pitch; 336-345 knee), which reproduce the reference's inline
    qmin/qmax set (main.cpp:493-494) in its own joint ordering.  A robot
    with different limits (models/zoo.py) overrides them wholesale via
    cfg.q_min_leg / cfg.q_max_leg.
    """
    if cfg.q_min_leg is not None:
        return (np.asarray(cfg.q_min_leg, float),
                np.asarray(cfg.q_max_leg, float))
    d2r = np.pi / 180.0
    qmin = np.zeros((4, 3))
    qmax = np.zeros((4, 3))
    for i, (sx, _sy) in enumerate(LEG_SIGNS):
        qmin[i, 0], qmax[i, 0] = -100 * d2r, 100 * d2r
        qmin[i, 1] = -0.5 * np.pi * (sx + 1) + 0.25 * np.pi * (sx - 1)
        qmax[i, 1] = 0.25 * np.pi * (sx + 1) - 0.5 * np.pi * (sx - 1)
        qmin[i, 2] = -0.01 * (sx + 1) + 150 * d2r * (sx - 1) / 2
        qmax[i, 2] = -0.01 * (sx - 1) + 150 * d2r * (sx + 1) / 2
    return qmin.reshape(12), qmax.reshape(12)


def inertia_matrix(cfg: RobotConfig) -> np.ndarray:
    """3x3 base rotational inertia about the CoM (dogbot_model.h:92)."""
    ixx, iyy, izz, ixy, ixz, iyz = cfg.inertia
    return np.array(
        [
            [ixx, ixy, ixz],
            [ixy, iyy, iyz],
            [ixz, iyz, izz],
        ]
    )


def default_joint_angles(cfg: RobotConfig) -> np.ndarray:
    """(12,) crouched standing pose: per-leg IK of the nominal stance.

    Computed lazily by models.kinematics at call sites; this provides the
    analytic seed (roll 0, knee bent outward per side) similar to the spawn
    pose in the reference launch (dogbot_gazebo/launch/dog.launch:17-31).
    """
    from . import kinematics

    return kinematics.stance_ik(cfg, nominal_stance(cfg))
