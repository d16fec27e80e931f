"""The engine's configuration tree — `apf_quadruped_tpu/config.py`, shared.

The frozen dataclasses are defined once, in the JAX package (pure
dataclasses, no jax import); see _shared.py for how the port loads them.
Two SolverConfig fields have no meaning on the port yet and make the
solvers raise when set: `use_pallas` and `stage_bf16` (ROADMAP queue 2).
"""

from ._shared import load_shared

_defs = load_shared(__name__ + "_defs", "config.py")

ApfConfig = _defs.ApfConfig
EngineConfig = _defs.EngineConfig
FootholdConfig = _defs.FootholdConfig
GaitConfig = _defs.GaitConfig
MpcConfig = _defs.MpcConfig
ObserverConfig = _defs.ObserverConfig
RobotConfig = _defs.RobotConfig
SimConfig = _defs.SimConfig
SolverConfig = _defs.SolverConfig
WbcConfig = _defs.WbcConfig
apf_fast = _defs.apf_fast
default_config = _defs.default_config

__all__ = ["ApfConfig", "EngineConfig", "FootholdConfig", "GaitConfig",
           "MpcConfig", "ObserverConfig", "RobotConfig", "SimConfig",
           "SolverConfig", "WbcConfig", "apf_fast", "default_config"]
