"""DogBot v4 model data — `apf_quadruped_tpu/models/dogbot.py`, shared.

That module is numpy-only; see ../_shared.py for how the port loads it.
`default_joint_angles` needs the leg kinematics, which are not ported
yet (ROADMAP slice B), so it is not re-exported.
"""

from .._shared import load_shared

_defs = load_shared(__name__ + "_defs", "models/dogbot.py")

LEGS = _defs.LEGS
LEG_SIGNS = _defs.LEG_SIGNS
NUM_LEGS = _defs.NUM_LEGS
hip_positions = _defs.hip_positions
inertia_matrix = _defs.inertia_matrix
joint_limits = _defs.joint_limits
nominal_stance = _defs.nominal_stance
repulsive_versors = _defs.repulsive_versors
