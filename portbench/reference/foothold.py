"""Decision-influenced foothold selection.

Port of apf_quadruped_tpu/foothold.py: a static K-candidate grid per swing
leg inside the range-of-motion box, scored on

    score = w_mu (mu_hi - mu(c)) + w_dist |c - apf_target|^2
            + w_slope (1 - n_z(c))          (height maps only)

with a per-lane argmin.  torch.argmin returns the first minimum, as
jnp.argmin does, so ties resolve the same way; on uniform flat ground the
zero offset wins and the APF step targets pass through unchanged.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .config import FootholdConfig, RobotConfig
from .models.dogbot import LEG_SIGNS
from .sim import terrain as terrain_mod


def candidate_grid_np(cfg: FootholdConfig, robot: RobotConfig) -> np.ndarray:
    """(K, 2) candidate offsets: an n x n grid spanning +-spread *
    max_dev_xy."""
    dev = np.asarray(robot.max_dev[:2]) * cfg.spread
    ax = np.linspace(-1.0, 1.0, cfg.grid_n)
    gx, gy = np.meshgrid(ax * dev[0], ax * dev[1], indexing="ij")
    return np.stack([gx.ravel(), gy.ravel()], -1)


@functools.lru_cache(maxsize=None)
def _consts(cfg: FootholdConfig, robot: RobotConfig, dtype, device):
    def t(v):
        return torch.as_tensor(np.asarray(v, np.float64), dtype=dtype,
                               device=device)
    return (t(candidate_grid_np(cfg, robot)),
            t(LEG_SIGNS * np.array([robot.stance_x, robot.stance_y])),
            t(robot.max_dev[:2]))


def candidate_grid(cfg: FootholdConfig, robot: RobotConfig,
                   dtype=torch.float32, device=None) -> torch.Tensor:
    return _consts(cfg, robot, dtype, device)[0]


def optimize(cfg: FootholdConfig, robot: RobotConfig,
             terr: terrain_mod.Terrain, step_xy: torch.Tensor,
             com_des_xy: torch.Tensor) -> torch.Tensor:
    """Footholds near the APF step targets that avoid low-friction (and
    steep) cells.  step_xy (B, 4, 2), com_des_xy (B, 2) -> (B, 4, 2),
    each inside the box nominal(com_des) +- max_dev."""
    offs, stance, dev = _consts(cfg, robot, step_xy.dtype, step_xy.device)
    cand = step_xy[..., None, :] + offs                   # (B, 4, K, 2)
    nominal = com_des_xy[..., None, :] + stance           # (B, 4, 2)
    cand = torch.clamp(cand, (nominal - dev)[..., None, :],
                       (nominal + dev)[..., None, :])

    mu = terrain_mod.sample_mu(terr, cand)                # (B, 4, K)
    d2 = ((cand - step_xy[..., None, :]) ** 2).sum(dim=-1)
    score = cfg.w_mu * (cfg.mu_hi - mu) + cfg.w_dist * d2
    if terr.h_map is not None:
        nz = terrain_mod.sample_normal(terr, cand)[..., 2]
        score = score + cfg.w_slope * (1.0 - nz)

    best = torch.argmin(score, dim=-1)                    # (B, 4)
    return torch.gather(cand, -2, best[..., None, None].expand(
        best.shape + (1, 2)))[..., 0, :]
