"""Write world_golden.npz: the JAX package's closed loop on the height-map
worlds of `run --world`, for the port's tests (float64, on the CPU) and
chip_smoke.py (float32, on a GPU machine that has no JAX) to hold the
port to.

The JAX CLI's `run --world <name>` path (apf_quadruped_tpu/__main__.py
cmd_run: `_cfg` with trot, H=20, one SQP iteration, SolverConfig(iters=15,
reltol=abstol=1e-2), slack_weight_trot=1e6; the world from
terrain.HEIGHT_WORLDS, target (0, 1.5), no disturbance, loop.init +
loop.run), one scenario, CYCLES replan cycles of 200 ticks, one loop.run
call a cycle.  With a height map the loop runs three branches that flat
worlds skip: the plan's friction-cone bases at every knot's scheduled
foothold, the WBC's cone bases at the measured feet, and contact and
early touch-down against the terrain's height.  Every feature of these
worlds starts 1 m ahead of the command's spawn at the origin, farther
than two cycles walk, so the robot spawns at (0, SPAWN[world]) with
loop.init's `xy`: its front feet step onto the feature in these cycles.

    slope   the ramp (35 degrees, from y = 1.0): the front feet land on it
            in cycle 1, where the plan's and the WBC's cones tilt;
    stairs  the 0.2 m step at y = 1.0: the front feet climb onto it in
            cycle 1, their contact and early touch-down against its
            height.

Stored per run and world, with a leading batch axis of 1 as the port's
batched loop gives them: the LoopState after cycle k
("<run>.<world>.c<k>.state.<path>") and the cycle's CycleMetrics
("<run>.<world>.c<k>.metrics.<field>", (1, 1, ...)), and the spawn
("spawn.<world>").  The runs: f64, its twins f64p / f64m / f64b, f32
and its twins f32p / f32m / f32b (tests/data/_golden.py).

Run from the repository root (about 1 minute on the CPU, two processes;
the file is about 0.5 MB):
    JAX_PLATFORMS=cpu python tests/data/make_world_golden.py
"""

from argparse import Namespace
from pathlib import Path

import numpy as np

import _golden

SPAWN = {"slope": 0.5, "stairs": 0.55}     # y of the spawn, m
TARGET, CYCLES = (0.0, 1.5), 2
OUT = Path(__file__).resolve().parent / "world_golden.npz"


def run(dtype_name: str, path: str):
    dtype = _golden.jax_dtype(dtype_name)
    import jax.numpy as jnp

    from apf_quadruped_tpu.__main__ import _cfg
    from apf_quadruped_tpu.runtime import loop
    from apf_quadruped_tpu.sim import disturbance, terrain

    cfg = _cfg(Namespace(iters=15, robot="dogbot", gait="trot", sqp=1))
    data = {}
    for world, y0 in SPAWN.items():
        terr = terrain.HEIGHT_WORLDS[world](cfg.sim, dtype=dtype)
        if dtype_name == "f64":
            data[f"spawn.{world}"] = np.asarray([0.0, y0])
        for name in _golden.runs_of(dtype_name):
            st = _golden.moved(loop.init(cfg, xy=(0.0, y0), dtype=dtype),
                               name)
            for k in range(CYCLES):
                st, m = loop.run(cfg, st, terr, jnp.asarray(TARGET, dtype),
                                 disturbance.empty(dtype), n_cycles=1)
                data.update(_golden.leaves(f"{name}.{world}.c{k}.state", st,
                                           batch_axis=True))
                data.update(_golden.leaves(f"{name}.{world}.c{k}.metrics", m,
                                           batch_axis=True))
            print(f"{name} {world}: CoM {np.asarray(m.com[-1]).tolist()}, "
                  f"R22 {float(st.sim.R_wb[2, 2])}", flush=True)
    _golden.save(path, data, dtype_name)


if __name__ == "__main__":
    _golden.main(OUT, __file__, run)
