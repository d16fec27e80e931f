"""Scheduled disturbance forces — the force_plugin replacement.

Port of apf_quadruped_tpu/sim/disturbance.py.  A disturbance is data: an
(n_events, 8) array of rows

    [t_start, t_end, fx, fy, fz, omega, phase, link]

evaluated branch-free at sim time t and summed.  `link` 0 is the base
origin, 1..4 the foot of a leg (applied through that foot's contact
Jacobian).  Rows with omega == 0 are constant pushes over [t_start, t_end);
others are modulated by sin(omega t + phase).  Legacy (n_events, 7)
schedules have no link column and act on the base.
"""

from __future__ import annotations

import numpy as np
import torch

NCOL = 8


def _tensor(v, dtype, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(v, np.float64), dtype=dtype,
                           device=device)


def empty(dtype=torch.float32, device=None) -> torch.Tensor:
    return torch.zeros((1, NCOL), dtype=dtype, device=device)


def impulses(events, dtype=torch.float32, device=None) -> torch.Tensor:
    """events: (t_start, t_end, fx, fy, fz) base pushes or (.., link) with
    link 1..4 = a leg's foot."""
    out = np.zeros((len(events), NCOL))
    for i, ev in enumerate(events):
        out[i, :5] = ev[:5]
        if len(ev) > 5:
            out[i, 7] = ev[5]
    return _tensor(out, dtype, device)


def sinusoidal(amp_xyz, omega: float, t0: float = 0.0, t1: float = 1e9,
               phase: float = 0.0, link: int = 0, dtype=torch.float32,
               device=None) -> torch.Tensor:
    """f(t) = amp sin(omega t + phase) over [t0, t1)."""
    ax, ay, az = amp_xyz
    return _tensor([[t0, t1, ax, ay, az, omega, phase, link]], dtype, device)


def leg_push(leg: int, amp_xyz, t0: float, t1: float, omega: float = 0.0,
             phase: float = 0.0, dtype=torch.float32,
             device=None) -> torch.Tensor:
    """Push leg `leg` (0..3) at its foot."""
    ax, ay, az = amp_xyz
    return _tensor([[t0, t1, ax, ay, az, omega, phase, leg + 1]], dtype,
                   device)


def random_pushes(rng: np.random.Generator, horizon_s: float, n=4,
                  f_max=60.0, dur=0.3, batch=1, dtype=torch.float32,
                  p_leg: float = 0.0, device=None) -> torch.Tensor:
    """(batch, n, 8) randomized pushes; draws from `rng` in the JAX
    module's order."""
    out = np.zeros((batch, n, NCOL))
    for b in range(batch):
        for i in range(n):
            t0 = rng.uniform(0.5, horizon_s - dur)
            f = rng.uniform(-f_max, f_max, 2)
            out[b, i, :5] = (t0, t0 + dur, f[0], f[1], 0.0)
            if rng.uniform() < p_leg:
                out[b, i, 7] = rng.integers(1, 5)
    return _tensor(out, dtype, device)


def _active_forces(schedule: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """(.., n_events, 3) per-row force at time t (..,)."""
    tt = t[..., None]
    active = (tt >= schedule[..., 0]) & (tt < schedule[..., 1])
    omega = schedule[..., 5]
    mod = torch.where(omega != 0, torch.sin(omega * tt + schedule[..., 6]),
                      torch.ones_like(omega))
    return schedule[..., 2:5] * (active * mod)[..., None]


def eval_at(schedule: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """(.., 3) total BASE force at time t (link != 0 rows excluded)."""
    f = _active_forces(schedule, t)
    if schedule.shape[-1] > 7:
        f = f * (schedule[..., 7:8] == 0)
    return f.sum(dim=-2)


def eval_links(schedule: torch.Tensor, t: torch.Tensor):
    """(f_base (.., 3), f_feet (.., 4, 3)) at time t."""
    f = _active_forces(schedule, t)
    if schedule.shape[-1] <= 7:
        return f.sum(dim=-2), torch.zeros(f.shape[:-2] + (4, 3),
                                          dtype=f.dtype, device=f.device)
    link = schedule[..., 7].to(torch.int64)
    onehot = (link[..., None] == torch.arange(5, device=f.device)).to(f.dtype)
    by_link = onehot.transpose(-1, -2) @ f                 # (.., 5, 3)
    return by_link[..., 0, :], by_link[..., 1:5, :]
