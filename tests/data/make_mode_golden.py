"""Write mode_golden.npz: the JAX package's batched closed loop in every
gait mode of the command line and across replan cycles, for the port's
tests (float64, on the CPU) and chip_smoke.py (float32, on a GPU machine
that has no JAX) to hold the port to.

The CLI's sweep configuration per mode (apf_quadruped_tpu/__main__.py
`_cfg`: DogBot, the gait mode, horizon 40 for the 1 s crawl / adaptive
cycle and 20 otherwise, one SQP iteration, SolverConfig(iters=15,
reltol=abstol=1e-2), slack_weight_trot=1e6), B=2 scenarios from
sweep.random_scenarios(seed=0, use_native=False) (slippery patches and
pushes), run cycle by cycle through sweep.init_batch and then
sweep.step_batch(..., 1) once a cycle:

    trot      3 cycles of 0.5 s  pair A, then pair B with the leg-permuted
                                 warm start, then pair A again
    crawl     1 cycle of 1 s     H=40, the crawl schedule and WBC masks
    pace      2 cycles of 0.5 s  a fixed stride (gait.NAMED_MODE_FLAGS 18),
                                 the warm start carried unpermuted
    adaptive  2 cycles of 1 s    the in-loop trot <-> crawl switch; cycle
                                 1's gait comes from cycle 0's robustness

Stored: the scenarios ("scn.<field>", float64; the float32 run's are
these cast to float32), and per run, case and cycle k the LoopState after
the cycle ("<run>.<case>.c<k>.state.<path>") and the cycle's CycleMetrics
("<run>.<case>.c<k>.metrics.<field>", (B, 1, ...)).  The runs:
    f64   the reference, float64;
    f64p  the float64 run once more from a start whose joint angles q are
          moved by 1e-12 rad: its distance from f64 is how far the loop
          itself carries a rounding (trot's second cycle to ~1e-4 in q,
          pace and crawl to ~1e-2, adaptive's second cycle to ~1e1), and
          the port's float64 run, which sums in another order, is held to
          f64 within a few times that spread;
    f64m  the same from q moved by -1e-12 rad, and
    f64b  from the base position moved by 1e-14 m (zoo_golden.npz's
          twin): two more samples of that spread.  Once a mode turns
          chaotic (pace's second cycle, where the WBC converges on ~60% of
          the ticks), one sample is no bound: the three twins' distances
          from f64 differ by up to 10x in a leaf;
    f32   float32, in its own process without jax_enable_x64;
    f32p, f32m, f32b  the float32 run from q moved by one float32 ulp up
          and down and from the base position moved by one ulp
          (tests/data/_golden.py F32_TWINS): how far the loop carries one
          float32 rounding, the spread chip_smoke.py allows the port's
          float32 run beside 5x the float32 run's distance from f64.

Run from the repository root (about 4.5 minutes on the CPU: each mode's
cycle compiles once a process; the file is about 1 MB):
    JAX_PLATFORMS=cpu python tests/data/make_mode_golden.py
"""

import subprocess
import sys
import tempfile
from argparse import Namespace
from pathlib import Path

import numpy as np

CASES = {"trot": 3, "crawl": 1, "pace": 2, "adaptive": 2}
B, SEED = 2, 0
OUT = Path(__file__).resolve().parent / "mode_golden.npz"
# the repository root, so that the command below finds the JAX package
sys.path.insert(0, str(OUT.parents[2]))

import _golden  # noqa: E402  (the twins: _golden.TWINS, F32_TWINS)


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

    from apf_quadruped_tpu.__main__ import _cfg
    from apf_quadruped_tpu.runtime import sweep

    dtype = jnp.float64 if dtype_name == "f64" else jnp.float32
    data = {}
    for case, cycles in CASES.items():
        cfg = _cfg(Namespace(iters=15, robot="dogbot", gait=case, sqp=1))
        scn = sweep.random_scenarios(cfg, B, seed=SEED, dtype=dtype,
                                     use_native=False)
        scn_np = _leaves("scn", scn)
        if "scn.mu_map" in data:
            for k, v in scn_np.items():
                np.testing.assert_array_equal(v, data[k], err_msg=k)
        data.update(scn_np)
        for name in _golden.runs_of(dtype_name):
            st = _golden.moved(sweep.init_batch(cfg, scn), name)
            for k in range(cycles):
                st, m = sweep.step_batch(cfg, scn, st, 1)
                data.update(_leaves(f"{name}.{case}.c{k}.state", st))
                data.update(_leaves(f"{name}.{case}.c{k}.metrics", m))
            print(f"{name} {case}: {cycles} cycles, final q finite "
                  f"{bool(np.isfinite(np.asarray(st.sim.q)).all())}",
                  flush=True)
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
                part_data = {k: f[k] for k in f.files}
            if name == "f32":
                # the float32 run walked the float64 scenarios, rounded
                for k in [k for k in part_data if k.startswith("scn.")]:
                    np.testing.assert_array_equal(
                        part_data.pop(k), data[k].astype(np.float32),
                        err_msg=k)
            data.update(part_data)
    np.savez_compressed(OUT, **data)
    print(f"wrote {OUT}: {len(data)} arrays, {OUT.stat().st_size} bytes")


if __name__ == "__main__":
    main()
