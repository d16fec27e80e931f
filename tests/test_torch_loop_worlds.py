"""The port's closed loop on the height-map worlds of `run --world` vs the
JAX package, on the CPU, in float64, against tests/data/world_golden.npz
(tests/data/make_world_golden.py) with tests/test_torch_loop_modes.py's
gates.

The `run` command's closed loop (__main__.run_closed_loop: the CLI's trot
configuration, one scenario, target (0, 1.5), no disturbance) on the
slope and the stairs, 2 cycles, cycle by cycle.  Every feature of these
worlds lies 1 m ahead of the command's spawn, farther than two cycles
walk, so the golden spawns the robot at (0, y0) with loop.init's `xy`,
and so does the port's run here.  A height map runs the branches flat
worlds skip: the plan's cone bases at every knot's foothold, the WBC's
at the measured feet, contact and early touch-down on the terrain's
height.  test_golden_reaches_the_features fails if a regenerated golden
stops putting feet on the features.
"""

from argparse import Namespace
from pathlib import Path

import numpy as np
import pytest
import torch

from apf_quadruped_tpu_torch import __main__ as cli
from apf_quadruped_tpu_torch.models import rbd
from apf_quadruped_tpu_torch.sim import terrain
from chip_smoke import world_cycles
from test_torch_loop_modes import check_case

torch.set_num_threads(1)

GOLDEN = Path(__file__).resolve().parent / "data" / "world_golden.npz"
WORLDS, CYCLES = ("slope", "stairs"), 2
# (world, cycle) -> the flag and count leaves the f64p twin flips, and the
# float leaves beyond 5x its spread (tests/test_torch_loop_modes.py)
TWIN_FLIPS = {}
BEYOND_F64P = {}


def world_config():
    return cli._cfg(Namespace(iters=15, robot="dogbot", gait="trot", sqp=1))


@pytest.fixture(scope="module")
def golden():
    with np.load(GOLDEN) as f:
        return {k: f[k] for k in f.files}


def port_cycles(golden, world):
    """[(LoopState, CycleMetrics (1, 1, ...))] after each cycle of the
    `run` command's closed loop on `world`, spawned where the golden
    spawned it (chip_smoke.world_cycles, which phase 24 runs on the
    card)."""
    cycles, _ = world_cycles(golden[f"spawn.{world}"].tolist(), world,
                             world_config(), CYCLES, "cpu", torch.float64)
    return [(st, m) for _, st, m in cycles]


@pytest.fixture(scope="module")
def runs(golden):
    return {world: port_cycles(golden, world) for world in WORLDS}


@pytest.mark.parametrize("world", WORLDS)
def test_golden_reaches_the_features(golden, world):
    """On the golden itself: after the last cycle a front foot (FL or FR)
    stands on the feature, where the ground is 3 cm or more above the
    flat, its sole on that ground (its centre a foot radius above it,
    within 1 cm)."""
    cfg = world_config()
    head = f"f64.{world}.c{CYCLES - 1}.state.sim."
    p, R, q = (torch.as_tensor(golden[head + leaf])
               for leaf in ("p_base", "R_wb", "q"))
    front = rbd.foot_positions_world(cfg.robot, p, R, q)[0, 2:]
    terr = terrain.HEIGHT_WORLDS[world](cfg.sim, dtype=torch.float64,
                                        device="cpu")
    ground = terrain.sample_height(terr, front[:, 0:2])
    above = front[:, 2] - ground - cfg.robot.foot_radius
    assert bool(((ground >= 0.03) & (above.abs() <= 0.01)).any()), \
        (ground, above)


@pytest.mark.parametrize("world,k", [(w, k) for w in WORLDS
                                     for k in range(CYCLES)])
def test_cycle_matches_jax(golden, runs, world, k):
    check_case(golden, runs, world, k, TWIN_FLIPS, BEYOND_F64P)
