"""The port's copy of runtime/viz.py renders the run and metric plots
(tests/test_viz.py's three plot tests), the metric panel from the port's
own closed loop: a run plot with fields and foothold overlay, a minimal
one, and a CycleMetrics panel, each a real PNG (headless Agg backend).
"""

import os

import numpy as np
import pytest
import torch

matplotlib = pytest.importorskip("matplotlib")

from apf_quadruped_tpu_torch import convert  # noqa: E402
from apf_quadruped_tpu_torch.config import (EngineConfig, GaitConfig,  # noqa: E402
                                            MpcConfig, SimConfig,
                                            SolverConfig, WbcConfig)
from apf_quadruped_tpu_torch.runtime import loop, viz  # noqa: E402
from apf_quadruped_tpu_torch.sim import disturbance, terrain  # noqa: E402

torch.set_num_threads(1)


def _synthetic_mu(res=64):
    rng = np.random.default_rng(3)
    mu = np.full((res, res), 0.8)
    mu[30:40, 25:35] = 0.15      # a slippery patch in the robot's path
    mu += 0.01 * rng.standard_normal((res, res))
    return np.clip(mu, 0.05, 1.0)


def test_plot_run_full(tmp_path):
    path = str(tmp_path / "run.png")
    com = np.stack([0.02 * np.sin(np.linspace(0, 3, 40)),
                    np.linspace(0.0, 1.5, 40)], axis=-1)
    feet = np.array([[0.19, -0.29], [-0.19, -0.29],
                     [-0.19, 0.29], [0.19, 0.29]])
    out = viz.plot_run(path, _synthetic_mu(), extent=3.0, com_traj=com,
                       target_xy=(0.0, 1.5), feet=feet,
                       f_att=np.tile([[0.0, 0.2]], (4, 1)),
                       f_rep=np.tile([[0.1, 0.0]], (4, 1)),
                       footholds=feet + [[0.0, 0.35]])
    assert out == path
    assert os.path.getsize(path) > 20_000


def test_plot_run_minimal(tmp_path):
    path = str(tmp_path / "run_min.png")
    com = np.stack([np.zeros(10), np.linspace(0, 0.5, 10)], axis=-1)
    viz.plot_run(path, _synthetic_mu(32), extent=2.0, com_traj=com)
    assert os.path.getsize(path) > 10_000


def test_plot_metrics_of_the_port_loop(tmp_path):
    """The panel from the port's CycleMetrics (lane 0 as numpy, as the
    `run` command passes them), so the field names viz indexes stay in
    step with runtime.loop.CycleMetrics."""
    cfg = EngineConfig(
        gait=GaitConfig(trot_cycle=0.1),
        mpc=MpcConfig(horizon=4, dt=0.025),
        sim=SimConfig(substeps=2, terrain_res=32),
        solver=SolverConfig(iters=6),
        wbc=WbcConfig(slack_weight_trot=1e6))
    st = loop.init(cfg, 1, device="cpu")
    _, metrics = loop.run(cfg, st, terrain.flat(cfg.sim, batch=(1,)),
                          torch.tensor([[0.0, 1.0]]),
                          disturbance.empty()[None], n_cycles=2)
    m = loop.CycleMetrics(*(None if v is None else convert.to_numpy(v[0])
                            for v in metrics))
    assert m.rob_mean.shape == (2,)
    path = str(tmp_path / "metrics.png")
    viz.plot_metrics(path, m)
    assert os.path.getsize(path) > 20_000
