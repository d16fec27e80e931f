"""Artificial-potential-field navigation + slippage robustness index.

Port of apf_quadruped_tpu/apf.py: per-foot goals, saturated attractive
errors with adaptive gains, slippage-driven repulsive fields, the
friction-cone robustness index with its stance integral and EWMA, the
left/right asymmetry index, the fake-crawl threshold and the CoM step
saturation.  Everything is elementwise over (.., 4)-shaped per-foot
tensors; ApfState carries the per-scenario memory across replans.
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple

import numpy as np
import torch

from ._device import constant
from .config import ApfConfig, RobotConfig
from .models.dogbot import LEG_SIGNS

THETA = math.atan(0.5)   # friction-cone half angle

_DEFAULT_STANCE = (RobotConfig.stance_x, RobotConfig.stance_y)


class ApfState(NamedTuple):
    """Per-scenario navigation state carried across replan cycles."""

    rob_foot: torch.Tensor    # (.., 4) EWMA robustness per foot
    h_int: torch.Tensor       # (.., 4) running margin integral
    period_st: torch.Tensor   # (..,) accumulated stance-tracking time


def init_state(batch=(), dtype=torch.float32, device=None) -> ApfState:
    """h_int = period_st = 0.01, so the first EWMA sees margin 1."""
    return ApfState(
        rob_foot=torch.zeros(batch + (4,), dtype=dtype, device=device),
        h_int=torch.full(batch + (4,), 0.01, dtype=dtype, device=device),
        period_st=torch.full(batch, 0.01, dtype=dtype, device=device))


def cone_margin(forces_w: torch.Tensor, eps: float = 1e-9) -> torch.Tensor:
    """Friction-cone margin angle theta - alpha, alpha = acos(f_z/|f|);
    zero-force feet give margin 0."""
    fz = forces_w[..., 2]
    fn = torch.linalg.vector_norm(forces_w, dim=-1)
    loaded = fn > eps
    cosa = torch.where(loaded, fz / torch.clamp(fn, min=eps),
                       torch.zeros_like(fz))
    alpha = torch.arccos(torch.clamp(cosa, -1.0, 1.0))
    return torch.where(loaded, THETA - alpha, torch.zeros_like(alpha))


def accumulate_margin(cfg: ApfConfig, state: ApfState, forces_w, dt):
    """One tracking-tick update of the margin integral + stance clock."""
    m = cone_margin(forces_w)
    gate = m > cfg.rob_floor
    return state._replace(
        h_int=state.h_int + torch.where(gate, m, torch.zeros_like(m)) * dt,
        period_st=state.period_st + dt)


def update_robustness(cfg: ApfConfig, state: ApfState) -> ApfState:
    """Per-replan EWMA update + integrator reset:
    rob = 0.35 rob + 0.65 h_int / period_st."""
    rob = (cfg.ewma_old * state.rob_foot
           + cfg.ewma_new * state.h_int / state.period_st[..., None])
    return ApfState(rob_foot=rob, h_int=torch.zeros_like(state.h_int),
                    period_st=torch.zeros_like(state.period_st))


def combined_asymmetry(cfg: ApfConfig, rob_foot) -> torch.Tensor:
    """Deadbanded left/right + front/back robustness asymmetry.  Leg order
    (BR, BL, FL, FR)."""
    br, bl, fl, fr = (rob_foot[..., i] for i in range(4))

    def fr_db(v):
        a = torch.abs(v)
        return torch.where(a < cfg.comb_deadband, torch.zeros_like(a), a)

    return (fr_db(br - bl) + fr_db(fr - fl)
            + fr_db(torch.abs(br - fr)) + fr_db(torch.abs(bl - fl)))


@functools.lru_cache(maxsize=None)
def _stance_offsets(robot, dtype, device) -> torch.Tensor:
    """(4, 2) nominal stance offsets (RobotConfig defaults without
    `robot`), built once per device."""
    sx, sy = ((robot.stance_x, robot.stance_y) if robot is not None
              else _DEFAULT_STANCE)
    return torch.as_tensor(LEG_SIGNS * np.array([sx, sy]), dtype=dtype,
                           device=device)


def foot_goals(target_xy, robot=None) -> torch.Tensor:
    """(.., 4, 2) per-foot goals = target +- nominal stance offsets."""
    return target_xy[..., None, :] + _stance_offsets(
        robot, target_xy.dtype, target_xy.device)


def attractive_gain(cfg: ApfConfig, e_a, fake_crawl) -> torch.Tensor:
    """(.., 4, 2) adaptive diagonal K_pa per foot: fake-crawl slows
    everything to the crawl gain; MIN_EXIT lowers the far-field gain."""
    near = torch.abs(e_a) < cfg.e_near_threshold

    def per_axis(kx, ky):
        return torch.stack([torch.full_like(e_a[..., 0], kx),
                            torch.full_like(e_a[..., 1], ky)], dim=-1)

    k_near = per_axis(cfg.kpa_x_near, cfg.kpa_y_near)
    k_far = per_axis(
        cfg.kpa_x_far_minexit if cfg.min_exit else cfg.kpa_x_far,
        cfg.kpa_y_far_minexit if cfg.min_exit else cfg.kpa_y_far)
    k = torch.where(near, k_near, k_far)
    kc = per_axis(cfg.kpa_x_crawl, cfg.kpa_y_crawl)
    if cfg.min_exit:
        kc = torch.where(near, kc, k_far)
    return torch.where(fake_crawl[..., None, None], kc, k)


def repulsive_versors(dtype=torch.float32, robot=None,
                      device=None) -> torch.Tensor:
    """(4, 2) outward unit vectors body center -> nominal foot."""
    v = _stance_offsets(robot, dtype, device)
    return v / torch.linalg.vector_norm(v, dim=-1, keepdim=True)


class ApfOutput(NamedTuple):
    f_att: torch.Tensor       # (.., 4, 2) attractive field per foot
    f_rep: torch.Tensor       # (.., 4, 2) repulsive field per foot
    step_targets: torch.Tensor  # (.., 4, 2) desired foot xy
    com_des: torch.Tensor     # (.., 2) step-saturated CoM goal
    fake_crawl: torch.Tensor  # (..,) bool — slow-gait flag
    rob_mean: torch.Tensor    # (..,) mean robustness
    comb_rob: torch.Tensor    # (..,)


def navigate(cfg: ApfConfig, state: ApfState, feet_xy, com_xy,
             target_xy, robot=None) -> ApfOutput:
    """One replan-cycle APF evaluation.

    feet_xy (.., 4, 2) current world foot xy, com_xy (.., 2), target_xy
    (.., 2); state holds the EWMA'd rob_foot (update_robustness first).
    With `robot`, step targets are clamped to the range-of-motion box
    nominal_stance +- max_dev around the saturated CoM goal.
    """
    dtype, dev = feet_xy.dtype, feet_xy.device
    rob = state.rob_foot
    rob_mean = rob.mean(dim=-1)
    fake_crawl = rob_mean < cfg.crawl_threshold
    comb = combined_asymmetry(cfg, rob)

    goals = foot_goals(target_xy, robot)
    e_a = torch.clamp(feet_xy - goals, -cfg.err_sat, cfg.err_sat)
    f_att = -attractive_gain(cfg, e_a, fake_crawl) * e_a

    vers = repulsive_versors(dtype, robot, dev)
    if cfg.min_exit:
        lat = constant((1.0, 0.0), dtype, dev)
        f_rep = (cfg.rep_gain_minexit * rob[..., None] * vers
                 + cfg.lat_gain_minexit * comb[..., None, None] * lat)
    else:
        f_rep = cfg.rep_gain * rob[..., None] * vers

    f_step = f_att + f_rep if cfg.rep_field_in_step else f_att
    step_targets = feet_xy + cfg.step_gain * f_step
    if cfg.step_reach > 0.0:
        step_targets = feet_xy + torch.clamp(step_targets - feet_xy,
                                             -cfg.step_reach, cfg.step_reach)

    com_raw = step_targets.mean(dim=-2)
    com_des = com_xy + torch.clamp(com_raw - com_xy, -cfg.step_sat,
                                   cfg.step_sat)

    if robot is not None:
        nominal = com_des[..., None, :] + _stance_offsets(robot, dtype, dev)
        dev_xy = constant(tuple(robot.max_dev[:2]), dtype, dev)
        step_targets = torch.clamp(step_targets, nominal - dev_xy,
                                   nominal + dev_xy)

    return ApfOutput(f_att=f_att, f_rep=f_rep, step_targets=step_targets,
                     com_des=com_des, fake_crawl=fake_crawl,
                     rob_mean=rob_mean, comb_rob=comb)
