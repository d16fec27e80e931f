"""Seeded problems for parity tests and the GPU smoke run.

`random_stage_qp` draws stage QPs with numpy, in the shapes of the JAX
suite's own make_problem (tests/test_pallas_riccati.py), optionally with
state rows and accel rows; the arrays feed both packages.
`bench_problem` builds the planner problem exactly as bench.py does:
DogBot standing in a trot schedule, a 6 cm CoM step, seeded noise.
"""

from __future__ import annotations

import numpy as np
import torch

from . import gait, planner
from ._device import resolve_device
from .config import EngineConfig
from .models import srb
from .models.dogbot import nominal_stance


def random_stage_qp(rng: np.random.Generator, B=4, H=5, NX=6, NU=4, M=6,
                    mask_frac=0.8, diag_q=True, mc=0, acc=False,
                    dtype=np.float32, a_noise=0.1) -> dict:
    """Dict of numpy arrays keyed by StageQP field.  mc > 0 adds mc state
    rows (+-e_d selectors of the first mc/2 states, as base_box builds
    them); acc=True adds accel-row bounds (needs NX=13, the SRB layout).
    A_k = I + a_noise N(0, 1): over a long horizon (H = 30) the default
    0.1 spreads the dynamics so far that float32 rounding alone moves a
    lane's stopping iteration; 0.03 keeps such a problem well posed."""
    A = (np.tile(np.eye(NX), (B, H, 1, 1))
         + rng.normal(size=(B, H, NX, NX)) * a_noise)
    Bm = rng.normal(size=(B, H, NX, NU)) * 0.3
    if diag_q:
        Q = np.diag(rng.uniform(0.5, 2.0, NX))
        R = np.diag(rng.uniform(0.1, 1.0, NU))
    else:
        W1 = rng.normal(size=(NX, NX)) * 0.3
        Q = W1 @ W1.T + 0.5 * np.eye(NX)
        W2 = rng.normal(size=(NU, NU)) * 0.3
        R = W2 @ W2.T + 0.2 * np.eye(NU)
    qp = dict(A=A, B=Bm, Q=Q, qlin=rng.normal(size=(B, H, NX)), R=R,
              G=rng.normal(size=(M, NU)), h=rng.uniform(0.5, 2.0, M),
              mask=(rng.uniform(size=(B, H, M)) < mask_frac).astype(float),
              x0=rng.normal(size=(B, NX)) * 0.5)
    if mc:
        Cx = np.zeros((mc, NX))
        for i in range(mc // 2):
            Cx[i, i] = 1.0
            Cx[mc // 2 + i, i] = -1.0
        qp.update(Cx=Cx, cx=rng.uniform(1.0, 2.0, (B, H, mc)),
                  mask_x=(rng.uniform(size=(B, H, mc)) < 0.9).astype(float))
    if acc:
        if NX != 13:
            raise ValueError("accel rows need the 13-state SRB layout")
        qp["acc_rhs"] = rng.uniform(0.5, 1.0, 6)
    return {k: np.asarray(v, dtype) for k, v in qp.items()}


def bench_problem(cfg: EngineConfig, B: int, seed: int = 0,
                  dtype=torch.float32, device="cuda"):
    """(state0, refs) of bench.py's planner problem at batch B, on the
    card unless `device` says otherwise."""
    device = resolve_device(device)
    rng = np.random.default_rng(seed)

    def t(v):
        return torch.as_tensor(np.asarray(v), device=device).to(dtype)

    com0 = t(np.array([0.0, 0.0, 0.4]) + rng.normal(size=(B, 3)) * 0.01)
    yaw = t(rng.normal(size=B) * 0.1)
    vel = t(rng.normal(size=(B, 3)) * 0.05)
    feet0 = t(nominal_stance(cfg.robot))[None] + com0[:, None, :]
    feet0[..., 2] = 0.0
    com_des = com0 + t([0.0, 0.06, 0.0])
    H, dt = cfg.mpc.horizon, cfg.mpc.dt
    cycle = torch.full((B,), H * dt, dtype=dtype, device=device)
    contacts = gait.horizon_contacts(
        torch.ones(B, dtype=torch.int32, device=device),
        torch.zeros(B, dtype=dtype, device=device), dt, H, cycle, dtype=dtype)
    zeros3 = torch.zeros((B, 3), dtype=dtype, device=device)
    refs = planner.MpcRefs(
        contacts=contacts,
        feet_w=planner.foothold_schedule(feet0, feet0, contacts),
        x_ref=planner.reference_trajectory(cfg, zeros3, com0, com_des, yaw,
                                           cycle),
        yaw_ref=yaw)
    zero = torch.zeros_like(yaw)
    x0 = srb.pack_state(torch.stack([zero, zero, yaw], dim=-1), com0, zeros3,
                        vel)
    return x0, refs
