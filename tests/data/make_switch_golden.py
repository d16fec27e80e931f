"""Write switch_golden.npz: the JAX package's adaptive gait mode switching
one lane into crawl while the other lane trots, and a lane leaving crawl,
for the port's tests (float64, on the CPU) and chip_smoke.py (float32, on
a GPU machine that has no JAX) to hold the port to.

The CLI's sweep configuration of `--gait adaptive` (apf_quadruped_tpu/
__main__.py `_cfg`: DogBot, H=40 over the 1 s cycle, one SQP iteration,
SolverConfig(iters=15, reltol=abstol=1e-2), slack_weight_trot=1e6), B=2
scenarios built here, no pushes, run cycle by cycle through
sweep.init_batch and then sweep.step_batch(..., 1) once a cycle, CYCLES
cycles.  A cycle's head updates the robustness EWMA (rob_mean) and picks
the gait per lane: crawl (gait flag 4) below crawl_enter_threshold 0.20,
back to trot (flag 15) above crawl_exit_threshold 0.28.  The lanes:

    lane 0  a 1 m x 1 m patch of mu 0.6 centred on the spawn (mu_default
            0.8 elsewhere), target (-0.5, 2.0): trots cycles 0 and 1 and
            enters crawl at cycle 2's head, so its warm start (flag 15) is
            discarded there while lane 1's stays valid;
    lane 1  mu_default everywhere, target (0, 1.0), started with
            LoopState.crawling = True: it leaves crawl at cycle 0's head
            (the exit branch) and trots on.

So cycle 2 has lanes that differ in `crawling`: the WBC's per-lane crawl
weight, a warm start valid in one lane only, and the plan's mixed masks.

The layout was chosen from the JAX float64 runs alone: every head's
rob_mean lies at least MARGIN (0.01) from 0.20 and 0.28 in the float64
run and in its three twins, and no twin flips `crawling` or the gait
flag (check_layout, before the file is written).  rob_mean at the heads:

    cycle         0      1        2
    lane 0, f64   0.65   0.3247   0.1782 (twins 0.1752-0.1816)
    lane 1, f64   0.65   0.3720   0.2395 (twins 0.2393-0.2396)
    lane 0, f32   0.65   0.3227   0.1832
    lane 1, f32   0.65   0.3690   0.2283

Lane 0's loop is chaotic from cycle 0 on (its WBC converges on ~73% of
the ticks; the float64 twins end the cycle up to 0.19 rad apart in q),
lane 1's from cycle 1: the port's float64 run is held to them on the CPU
within their spread, and chip_smoke.py leaves a lane out of its float32
comparison from the cycle where it turns chaotic.

Stored: the scenarios ("scn.<field>", float64; the float32 run's are these
cast to float32), the start's crawling flags ("init.crawling"), and per
run and cycle k the LoopState after the cycle
("<run>.switch.c<k>.state.<path>") and the cycle's CycleMetrics
("<run>.switch.c<k>.metrics.<field>", (B, 1, ...)).  The runs: f64, its
twins f64p / f64m / f64b, f32 and its twins f32p / f32m / f32b
(tests/data/_golden.py).

Run from the repository root (about 1 minute on the CPU, two processes;
the file is about 0.5 MB):
    JAX_PLATFORMS=cpu python tests/data/make_switch_golden.py
"""

from argparse import Namespace
from pathlib import Path

import numpy as np

import _golden

CASE, CYCLES = "switch", 3
# lane: (mu of a patch under the spawn or None, target, crawling at the
# start)
LANES = ((0.6, (-0.5, 2.0), False), (None, (0.0, 1.0), True))
PATCH = 1.0         # m, the side of a lane's patch, centred on the spawn
MARGIN = 0.01       # least |rob_mean - threshold| at a head, every run
OUT = Path(__file__).resolve().parent / "switch_golden.npz"


def scenarios(cfg):
    """The lanes' scenarios as float64 numpy, sweep.Scenario's fields."""
    from apf_quadruped_tpu.sim import disturbance, terrain

    res = cfg.sim.terrain_res
    maps = []
    for mu, _, _ in LANES:
        m = np.full((res, res), cfg.sim.mu_default)
        if mu is not None:
            m = terrain.add_box(cfg.sim, m, 0.0, 0.0, PATCH, PATCH, mu)
        maps.append(m)
    B = len(LANES)
    return dict(mu_map=np.stack(maps),
                target_xy=np.asarray([t for _, t, _ in LANES]),
                dist_sched=np.zeros((B, 1, disturbance.NCOL)),
                spawn_xy=np.zeros((B, 2)), spawn_yaw=np.zeros(B))


def check_layout(data):
    """Every head's rob_mean at least MARGIN from both thresholds in the
    float64 run and its twins, and no twin flips a gait decision; the
    float32 run's rob_mean printed."""
    from apf_quadruped_tpu.config import ApfConfig

    lo, hi = ApfConfig.crawl_enter_threshold, ApfConfig.crawl_exit_threshold
    for k in range(CYCLES):
        head = f"{CASE}.c{k}."
        for dtype_name in ("f64", "f32"):
            ref = {leaf: data[f"{dtype_name}.{head}{leaf}"] for leaf in
                   ("metrics.crawling", "state.warm_flag")}
            for name in _golden.runs_of(dtype_name):
                rob = data[f"{name}.{head}metrics.rob_mean"][:, 0]
                print(f"{name} cycle {k}: rob_mean {rob.tolist()}, crawling "
                      f"{data[f'{name}.{head}metrics.crawling'][:, 0]}, "
                      f"warm_flag {data[f'{name}.{head}state.warm_flag']}")
                if dtype_name == "f32":
                    continue
                margin = np.minimum(np.abs(rob - lo), np.abs(rob - hi)).min()
                assert margin >= MARGIN, (name, k, rob)
                for leaf, v in ref.items():
                    np.testing.assert_array_equal(
                        data[f"{name}.{head}{leaf}"], v, err_msg=(name, k))


def run(dtype_name: str, path: str):
    dtype = _golden.jax_dtype(dtype_name)
    import jax.numpy as jnp

    from apf_quadruped_tpu.__main__ import _cfg
    from apf_quadruped_tpu.runtime import sweep

    cfg = _cfg(Namespace(iters=15, robot="dogbot", gait="adaptive", sqp=1))
    scn_np = scenarios(cfg)
    scn = sweep.Scenario(**{k: jnp.asarray(v, dtype)
                            for k, v in scn_np.items()})
    crawling = np.asarray([c for _, _, c in LANES])
    data = _golden.leaves("scn", scn)
    data["init.crawling"] = crawling
    for name in _golden.runs_of(dtype_name):
        st = sweep.init_batch(cfg, scn)
        st = _golden.moved(st._replace(crawling=jnp.asarray(crawling)), name)
        for k in range(CYCLES):
            st, m = sweep.step_batch(cfg, scn, st, 1)
            data.update(_golden.leaves(f"{name}.{CASE}.c{k}.state", st))
            data.update(_golden.leaves(f"{name}.{CASE}.c{k}.metrics", m))
        print(f"{name}: {CYCLES} cycles, crawling "
              f"{np.asarray(m.crawling[:, 0]).tolist()}, R22 "
              f"{np.asarray(st.sim.R_wb[:, 2, 2]).tolist()}", flush=True)
    _golden.save(path, data, dtype_name)


if __name__ == "__main__":
    _golden.main(OUT, __file__, run, check_layout)
