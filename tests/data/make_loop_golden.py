"""Write loop_golden.npz: the JAX package's batched closed loop, for the
port's tests (float64, on the CPU) and chip_smoke.py (float32, on a GPU
machine that has no JAX) to hold the port to.

The CLI's `sweep` configuration (trot, H=20, SolverConfig(iters=15,
reltol=abstol=1e-2), slack_weight_trot=1e6), B=4 scenarios from
sweep.random_scenarios(seed=0, use_native=False), one replan cycle (200
ticks), run through sweep.init_batch + sweep.step_batch and through
sweep.run_batch, in float64 and in float32 (each in its own process, the
float32 one without jax_enable_x64).  Stored: the scenarios (float64),
and per dtype the final LoopState leaves ("<dtype>.state.<path>"), the
CycleMetrics ("<dtype>.metrics.<field>", (B, 1, ...)) and the
SweepResult fields ("<dtype>.result.<field>").

Run from the repository root (a few minutes: the loop compiles twice per
dtype):
    JAX_PLATFORMS=cpu python tests/data/make_loop_golden.py
"""

import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np

B, CYCLES, SEED = 4, 1, 0
OUT = Path(__file__).resolve().parent / "loop_golden.npz"


def _leaves(prefix, tree):
    """{prefix.field[.field]: numpy} of a NamedTuple tree."""
    out = {}
    for name, value in tree._asdict().items():
        key = f"{prefix}.{name}"
        if hasattr(value, "_asdict"):
            out.update(_leaves(key, value))
        elif value is not None:
            out[key] = np.asarray(value)
    return out


def run(dtype_name: str, path: str):
    import jax

    if dtype_name == "f64":
        jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp

    from apf_quadruped_tpu.config import (EngineConfig, GaitConfig, MpcConfig,
                                          SolverConfig, WbcConfig)
    from apf_quadruped_tpu.runtime import sweep

    dtype = jnp.float64 if dtype_name == "f64" else jnp.float32
    cfg = EngineConfig(gait=GaitConfig(mode="trot"),
                       mpc=MpcConfig(horizon=20, sqp_iters=1),
                       solver=SolverConfig(iters=15, reltol=1e-2,
                                           abstol=1e-2),
                       wbc=WbcConfig(slack_weight_trot=1e6))
    scn = sweep.random_scenarios(cfg, B, seed=SEED, dtype=dtype,
                                 use_native=False, device="cpu")
    states, metrics = sweep.step_batch(cfg, scn, sweep.init_batch(cfg, scn),
                                       CYCLES)
    res = sweep.run_batch(cfg, scn, CYCLES)
    for a, b in zip(metrics, res.metrics):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    data = {**_leaves(f"{dtype_name}.state", states),
            **_leaves(f"{dtype_name}.metrics", metrics),
            **{f"{dtype_name}.result.{k}": np.asarray(v)
               for k, v in res._asdict().items() if k != "metrics"}}
    if dtype_name == "f64":
        data.update(_leaves("scn", scn))
    for k, v in data.items():
        assert k.startswith("scn") or v.dtype != np.float64 \
            or dtype_name == "f64", f"{k} is float64 in the float32 run"
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
