"""Write zoo_golden.npz: the JAX package's closed loop for the zoo robots
(anymal, hyq), for the port's tests (float64, on the CPU) and
chip_smoke.py (float32, on a GPU machine that has no JAX) to hold the
port to.

The JAX CLI's `run --robot <name>` configuration (apf_quadruped_tpu/
__main__.py `_cfg`: zoo.engine_config_for(name) with trot, H=20, one SQP
iteration, SolverConfig(iters=15, reltol=abstol=1e-2),
slack_weight_trot=1e6), flat ground, target (0, 1.5), one scenario, one
replan cycle (200 ticks) through loop.init + loop.run, in float64 and in
float32 (each in its own process, the float32 one without
jax_enable_x64).  Stored per dtype and robot, with a leading batch axis
of 1 as the port's batched loop gives them: the final LoopState leaves
("<dtype>.<robot>.state.<path>") and the CycleMetrics
("<dtype>.<robot>.metrics.<field>", (1, 1, ...)).  Also stored, as
"f64p.<robot>...": the float64 run once more from a start whose base
position is moved by 1e-14 m.  Its distance from the float64 run is how
far the loop itself carries a rounding in 200 ticks of stiff penalty
contact; the port's float64 run, which sums in another order, is held to
the golden within a few times that spread.

Run from the repository root (a few minutes: the loop compiles once per
robot and dtype):
    JAX_PLATFORMS=cpu python tests/data/make_zoo_golden.py
"""

import subprocess
import sys
import tempfile
from argparse import Namespace
from pathlib import Path

import numpy as np

ROBOTS = ("anymal", "hyq")
TARGET, CYCLES = (0.0, 1.5), 1
PERTURB = 1e-14     # m, added to the start's base position in "f64p"
OUT = Path(__file__).resolve().parent / "zoo_golden.npz"


def _leaves(prefix, tree):
    """{prefix.field[.field]: numpy with a batch axis of 1}."""
    out = {}
    for name, value in tree._asdict().items():
        key = f"{prefix}.{name}"
        if hasattr(value, "_asdict"):
            out.update(_leaves(key, value))
        elif value is not None:
            out[key] = np.asarray(value)[None]
    return out


def run(dtype_name: str, path: str):
    import jax

    if dtype_name == "f64":
        jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp

    from apf_quadruped_tpu.__main__ import _cfg
    from apf_quadruped_tpu.runtime import loop
    from apf_quadruped_tpu.sim import disturbance, terrain

    dtype = jnp.float64 if dtype_name == "f64" else jnp.float32
    data = {}
    for robot in ROBOTS:
        cfg = _cfg(Namespace(iters=15, robot=robot, gait="trot", sqp=1))
        st, m = loop.run(cfg, loop.init(cfg, dtype=dtype),
                         terrain.flat(cfg.sim, dtype=dtype),
                         jnp.asarray(TARGET, dtype), disturbance.empty(dtype),
                         n_cycles=CYCLES)
        data.update(_leaves(f"{dtype_name}.{robot}.state", st))
        data.update(_leaves(f"{dtype_name}.{robot}.metrics", m))
        if dtype_name == "f64":
            st0 = loop.init(cfg, dtype=dtype)
            st0 = st0._replace(sim=st0.sim._replace(
                p_base=st0.sim.p_base + PERTURB))
            st, m = loop.run(cfg, st0, terrain.flat(cfg.sim, dtype=dtype),
                             jnp.asarray(TARGET, dtype),
                             disturbance.empty(dtype), n_cycles=CYCLES)
            data.update(_leaves(f"f64p.{robot}.state", st))
            data.update(_leaves(f"f64p.{robot}.metrics", m))
    for k, v in data.items():
        assert v.dtype != np.float64 or dtype_name == "f64", \
            f"{k} is float64 in the float32 run"
    np.savez(path, **data)


def main():
    if len(sys.argv) == 3:
        run(sys.argv[1], sys.argv[2])
        return
    data = {}
    with tempfile.TemporaryDirectory() as tmp:
        for name in ("f64", "f32"):
            part = str(Path(tmp) / f"{name}.npz")
            subprocess.run([sys.executable, __file__, name, part], check=True)
            with np.load(part) as f:
                data.update({k: f[k] for k in f.files})
    np.savez_compressed(OUT, **data)
    print(f"wrote {OUT}: {len(data)} arrays")


if __name__ == "__main__":
    main()
