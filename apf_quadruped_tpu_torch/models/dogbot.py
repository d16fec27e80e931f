"""DogBot v4 model data — `apf_quadruped_tpu/models/dogbot.py`, shared.

That module is numpy-only; see ../_shared.py for how the port loads it.
Its `default_joint_angles` imports `.kinematics`, which resolves to the
port's models/kinematics.py, so it returns a float64 tensor.
"""

from .._shared import load_shared

_defs = load_shared(__name__ + "_defs", "models/dogbot.py")

LEGS = _defs.LEGS
LEG_SIGNS = _defs.LEG_SIGNS
NUM_LEGS = _defs.NUM_LEGS
default_joint_angles = _defs.default_joint_angles
hip_positions = _defs.hip_positions
inertia_matrix = _defs.inertia_matrix
joint_limits = _defs.joint_limits
nominal_stance = _defs.nominal_stance
repulsive_versors = _defs.repulsive_versors
