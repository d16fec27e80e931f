"""Robot model zoo for the SRB MPC layer (towr's example model family).

The port's copy of apf_quadruped_tpu/models/zoo.py (numpy and the port's
config.py; tests/test_torch_hygiene.py holds it to the original).

Transcribed from the reference's towr model headers
(include/towr/models/examples/{anymal,hyq,biped,monoped}_model.h — mass,
base inertia, nominal stance, max deviation).  The MPC planner is
robot-agnostic given (mass, inertia, footholds, contact schedule); robots
with fewer than four end-effectors pad to the fixed 4-slot layout with
permanently-masked feet, so every model runs through the same jit program
(shape-static, like everything else here).

Axis convention: this package uses +y forward / +x lateral
(models/dogbot.py); towr's examples use +x forward, so their stances are
rotated into ours (x_towr -> y, y_towr -> -x).
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np


class SrbModel(NamedTuple):
    name: str
    mass: float
    inertia: Tuple[float, ...]         # (Ixx, Iyy, Izz, Ixy, Ixz, Iyz)
    nominal_stance: np.ndarray         # (4, 3) base frame, padded
    foot_mask: np.ndarray              # (4,) 1.0 = real end-effector
    max_dev: Tuple[float, float, float]
    com_height: float


def _quad_stance(x_fwd, y_lat, z):
    """towr LF/RF/LH/RH stance -> our (BR, BL, FL, FR) order and axes."""
    # our frame: x lateral (right +), y forward
    return np.array([
        [+y_lat, -x_fwd, z],   # BR  (towr RH)
        [-y_lat, -x_fwd, z],   # BL  (towr LH)
        [-y_lat, +x_fwd, z],   # FL  (towr LF)
        [+y_lat, +x_fwd, z],   # FR  (towr RF)
    ])


def _rot_inertia_xy(i6):
    """Rotate an inertia tuple by 90deg about z (towr x-forward -> our
    y-forward): Ixx <-> Iyy, Ixy -> -Ixy(sym), Ixz <-> -Iyz."""
    ixx, iyy, izz, ixy, ixz, iyz = i6
    return (iyy, ixx, izz, -ixy, -iyz, ixz)


def anymal() -> SrbModel:
    """ANYmal (anymal_model.h: 29.5 kg, stance (0.34, 0.19, -0.42))."""
    return SrbModel(
        name="anymal", mass=29.5,
        inertia=_rot_inertia_xy((0.946438, 1.94478, 2.01835, 0.000938112,
                                 -0.00595386, -0.00146328)),
        nominal_stance=_quad_stance(0.34, 0.19, -0.42),
        foot_mask=np.ones(4), max_dev=(0.1, 0.15, 0.10), com_height=0.42)


def hyq() -> SrbModel:
    """HyQ (hyq_model.h: 83 kg, stance (0.31, 0.29, -0.58))."""
    return SrbModel(
        name="hyq", mass=83.0,
        inertia=_rot_inertia_xy((4.26, 8.97, 9.88, -0.0063, 0.193, 0.0126)),
        nominal_stance=_quad_stance(0.31, 0.29, -0.58),
        foot_mask=np.ones(4), max_dev=(0.20, 0.25, 0.10), com_height=0.58)


def dogbot() -> SrbModel:
    """DogBot (dogbot_model.h; native convention, no rotation needed)."""
    return SrbModel(
        name="dogbot", mass=21.261,
        inertia=(1.6375, 0.7098, 2.0399, -0.000291252, -0.000179158,
                 0.0737803),
        nominal_stance=np.array([
            [+0.186571, -0.289186, -0.402],
            [-0.186571, -0.289186, -0.402],
            [-0.186571, +0.289186, -0.402],
            [+0.186571, +0.289186, -0.402]]),
        foot_mask=np.ones(4), max_dev=(0.1, 0.15, 0.06), com_height=0.4)


def biped() -> SrbModel:
    """Biped (biped_model.h: 20 kg, feet at y = +-0.20, z = -0.65);
    slots BR/BL used, front slots masked."""
    stance = np.zeros((4, 3))
    stance[0] = [+0.20, 0.0, -0.65]
    stance[1] = [-0.20, 0.0, -0.65]
    stance[2] = [-0.20, 0.3, -0.65]     # masked
    stance[3] = [+0.20, 0.3, -0.65]     # masked
    return SrbModel(
        name="biped", mass=20.0,
        inertia=_rot_inertia_xy((1.209, 5.583, 6.056, 0.005, -0.190,
                                 -0.012)),
        nominal_stance=stance, foot_mask=np.array([1.0, 1.0, 0.0, 0.0]),
        max_dev=(0.15, 0.25, 0.15), com_height=0.65)


def monoped() -> SrbModel:
    """Monoped hopper (monoped_model.h: 20 kg, foot at (0, 0, -0.58))."""
    stance = np.zeros((4, 3))
    stance[:, 2] = -0.58
    return SrbModel(
        name="monoped", mass=20.0,
        inertia=_rot_inertia_xy((1.2, 5.5, 6.0, 0.0, -0.2, -0.01)),
        nominal_stance=stance, foot_mask=np.array([1.0, 0.0, 0.0, 0.0]),
        max_dev=(0.15, 0.25, 0.2), com_height=0.58)


ZOO = {m().name: m for m in (dogbot, anymal, hyq, biped, monoped)}


def robot_config_for(model: SrbModel):
    """Full RobotConfig for the model.

    Quadrupeds (anymal, hyq) carry a complete roll-pitch-knee leg chain —
    geometry, link masses/inertias, limits — so kinematics, rigid-body
    dynamics, the WBC, and the closed loop all serve them (not just the
    SRB planner).  The SRB constants (mass, inertia, stance, max_dev) are
    towr's (anymal_model.h / hyq_model.h); the reference ships no leg
    URDFs for these robots, so the chain parameters are representative
    values chosen to realize the towr stance (total link mass == SRB
    mass, nominal stance reachable with bent knees).  Biped/monoped stay
    SRB-only (their topology is not a 4x roll-pitch-knee chain).
    """
    from ..config import RobotConfig

    if model.name in _FULL_CONFIGS:
        return _FULL_CONFIGS[model.name]()
    return RobotConfig(mass=model.mass, inertia=tuple(model.inertia),
                       com_height=model.com_height,
                       max_dev=tuple(model.max_dev))


def _limits_symmetric(roll, pitch, knee):
    lo = tuple([-roll, -pitch, -knee] * 4)
    hi = tuple([roll, pitch, knee] * 4)
    return lo, hi


def anymal_robot_config():
    """ANYmal closed-loop RobotConfig (SRB constants: anymal_model.h).

    Leg chain: hips 0.2775 m fore/aft and 0.116 m lateral of the base
    origin, thighs in the foot's lateral plane (0.19 m), 0.25 m upper /
    0.33 m lower links — the towr stance (0.34 fwd, 0.19 lat, 0.42 down)
    sits comfortably inside the 0.58 m reach.  Link masses sum to the
    SRB 29.5 kg."""
    from ..config import RobotConfig

    m = anymal()
    qlo, qhi = _limits_symmetric(1.0, 2.6, 2.8)
    return RobotConfig(
        mass=m.mass, inertia=tuple(m.inertia),
        stance_x=0.19, stance_y=0.34, stance_z=-0.42,
        max_dev=tuple(m.max_dev), com_height=m.com_height,
        hip_offset_side=0.116, hip_offset=0.2775, leg_offset_side=0.19,
        upper_leg_len=0.25, lower_leg_len=0.33,
        foot_radius=0.02, foot_y_offset=0.0,
        tau_max=40.0, qd_max=7.5,
        q_min_leg=qlo, q_max_leg=qhi,
        body_mass=16.756, body_inertia=(0.45, 0.15, 0.58),
        hip_mass=1.42, hip_com_x=0.02,
        hip_inertia=(0.003, 0.003, 0.003),
        upper_mass=1.2, upper_com=(0.03, 0.0, -0.06),
        upper_inertia=(0.01, 0.01, 0.002),
        lower_mass=0.5, lower_com=(0.0, 0.0, -0.14),
        lower_inertia=(0.006, 0.006, 0.0005),
        foot_mass=0.066)


def hyq_robot_config():
    """HyQ closed-loop RobotConfig (SRB constants: hyq_model.h); same
    representative-chain construction as anymal_robot_config.

    Leg segments are 0.35/0.35 m (the real HyQ's upper/lower leg
    lengths).  This matters beyond fidelity: at the 0.58 m towr stance
    the knee's horizontal lever to the foot is 0.20 m, so the 150 Nm
    knee delivers ~750 N of leg force — with 0.38 m segments the lever
    grows to 0.25 m and the two-leg diagonal-stance loads of a trotting
    83 kg robot (~600 N/leg) saturate the knee, which was measured to
    topple the closed loop (the MpcConfig.fz_max=500 cap in
    engine_config_for keeps the planner inside the same envelope)."""
    from ..config import RobotConfig

    m = hyq()
    qlo, qhi = _limits_symmetric(1.0, 2.6, 2.8)
    # com_height is the NAVIGATION/MPC CoM z-target: the base stands at
    # 0.58 (towr stance) but the whole-body CoM sits ~0.06 below the base
    # origin (leg mass), so the closed-loop target is 0.54 — aiming for
    # 0.58 would drive the legs into the straight-knee singularity.
    return RobotConfig(
        mass=m.mass, inertia=tuple(m.inertia),
        stance_x=0.29, stance_y=0.31, stance_z=-0.58,
        max_dev=tuple(m.max_dev), com_height=0.54,
        hip_offset_side=0.12, hip_offset=0.31, leg_offset_side=0.29,
        upper_leg_len=0.35, lower_leg_len=0.35,
        foot_radius=0.02, foot_y_offset=0.0,
        tau_max=150.0, qd_max=12.0,
        q_min_leg=qlo, q_max_leg=qhi,
        body_mass=50.0, body_inertia=(1.5, 1.0, 2.0),
        hip_mass=2.5, hip_com_x=0.03,
        hip_inertia=(0.01, 0.01, 0.01),
        upper_mass=3.5, upper_com=(0.03, 0.0, -0.1),
        upper_inertia=(0.05, 0.05, 0.01),
        lower_mass=2.0, lower_com=(0.0, 0.0, -0.15),
        lower_inertia=(0.03, 0.03, 0.003),
        foot_mass=0.25)


_FULL_CONFIGS = {"anymal": anymal_robot_config, "hyq": hyq_robot_config}


def engine_config_for(name: str):
    """EngineConfig whose whole stack (navigation, MPC, WBC, sim) runs
    the named robot.  For anymal/hyq this is the CLOSED-LOOP config; for
    biped/monoped, SRB-planner-only constants.

    The fake-crawl threshold (main.cpp:1320, 0.34) is DogBot-tuned: the
    robustness index's steady-state level is robot-dependent (it
    integrates normalized friction-cone margins, which scale with the
    robot's force distribution).  Measured flat-ground steady state:
    DogBot ~0.5, anymal/hyq ~0.3 — so the heavier robots get a 0.22
    threshold that preserves the reference semantics (trigger on genuine
    margin loss, not on nominal walking).

    HyQ additionally re-scales the DogBot-tuned control/sim constants
    to its 83 kg / 150 Nm envelope — each override was ABLATED (12-cycle
    f64 closed loop; removing any single one topples the robot):
      * apf.step_reach 0.08: per-cycle foot step limit (see ApfConfig —
        the 0.25 m towr RoM box otherwise lets footholds outrun the
        0.06 m/cycle CoM step, permanently rear-loading the robot);
      * mpc.fz_max 500: keeps planned leg forces inside the knee-torque
        envelope (see hyq_robot_config);
      * wbc.kp_swing 100 / kd_swing 15: the DogBot gains (300/20)
        command swing accelerations whose torque exceeds 150 Nm on the
        3.5 + 2.0 kg legs, making the soft-tracking + hard-torque QP
        near-infeasible at swing onset (measured gap ~1e7);
      * sim ground/tangent springs x4: the DogBot-scaled penalty
        stiffness (20 kN/m) lets an 83 kg robot sink 1 cm per foot —
        deep-penetration contact dynamics the WBC cannot track."""
    from ..config import (ApfConfig, EngineConfig, MpcConfig, SimConfig,
                          WbcConfig)

    robot = robot_config_for(ZOO[name]())
    if name == "hyq":
        return EngineConfig(
            robot=robot,
            apf=ApfConfig(crawl_threshold=0.22, step_reach=0.08),
            mpc=MpcConfig(fz_max=500.0),
            wbc=WbcConfig(kp_swing=100.0, kd_swing=15.0),
            sim=SimConfig(ground_kp=80000.0, ground_kd=800.0,
                          tangent_kp=80000.0, tangent_kd=400.0))
    apf = ApfConfig(crawl_threshold=0.22) if name in _FULL_CONFIGS \
        else ApfConfig()
    return EngineConfig(robot=robot, apf=apf)
