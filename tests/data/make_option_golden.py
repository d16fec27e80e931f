"""Write option_golden.npz: the JAX package's batched closed loop under each
opt-in option of EngineConfig that changes a closed loop's result, one at
a time, for the port's tests (float64, on the CPU) and chip_smoke.py
(float32, on a GPU machine that has no JAX) to hold the port to.

The CLI's sweep configuration (apf_quadruped_tpu/__main__.py `_cfg`:
DogBot trot, H=20, one SQP iteration, SolverConfig(iters=15,
reltol=abstol=1e-2), slack_weight_trot=1e6) with exactly one field
changed per case (CASES), B=2 scenarios from
sweep.random_scenarios(seed=0, use_native=False) (slippery patches and
pushes), run cycle by cycle through sweep.init_batch and then
sweep.step_batch(..., 1) once a cycle, CYCLES cycles: the second runs
trot pair B from the first's leg-permuted warm start (with base_acc, the
warm start's 12 acceleration rows carried unpermuted).

foothold.enabled=False runs on scenarios of its own (FOOTHOLD_SCN):
on the shared ones no step target comes near a patch that
foothold.optimize would move it off, and the option's run equals the
default's bit for bit.  Its scenarios are lanes 0 and 1 of
random_scenarios(n=16, seed=1, use_native=False), chosen from JAX float64
runs alone (the 16 lanes, 2 cycles, with the option on and off): lane 1
is the only one of the 16 where the two differ.  In cycle 1 its default
run steps off a patch of mu ~0.4 that its run with the option off steps
onto (foot_mu 0.6936 and 0.5872 at n=16), and the two end the cycle
0.30 rad apart in q while the float64 twin stays within 2e-11 of its
run.  The golden keeps the default's run on these scenarios
("on.foothold_off.c<k>.state.sim.q" and ".metrics.foot_mu", float64)
and check_foothold asserts, before the file is written, that the two
differ by more than FOOTHOLD_MOVES in q where every twin stays within
1e-6 of its run.

SolverConfig.stage_bf16, use_pallas and MpcConfig.backend="riccati_fused"
have no case: the JAX package's CPU route for the first two is the scan,
which ignores stage_bf16 and runs use_pallas's kernel only in interpret
mode, and riccati_fused runs its three Pallas kernels there in interpret
mode too, far too slow for 400 ticks.  Their plans are held to the JAX
package by tests/test_torch_stage_bf16.py (stage_bf16, and the fused
passes against the JAX kernels in interpret mode) and
tests/test_torch_chol_solve.py (use_pallas's solve).

Stored: the scenarios ("scn.<field>", and foothold_off's
"scn_foothold_off.<field>", float64; the float32 run's are these cast to
float32), each case's changed field ("case.<case>.<section>.<field>",
its value), and per run, case and cycle k the LoopState after the
cycle ("<run>.<case>.c<k>.state.<path>") and the cycle's CycleMetrics
("<run>.<case>.c<k>.metrics.<field>", (B, 1, ...)).  The runs: f64, its
twins f64p / f64m / f64b, f32 and its twins f32p / f32m / f32b
(tests/data/_golden.py).

Run from the repository root (about 6.5 minutes on the CPU, two
processes: each case compiles its cycle once a process; the file is about
3 MB):
    JAX_PLATFORMS=cpu python tests/data/make_option_golden.py
"""

import dataclasses
from argparse import Namespace
from pathlib import Path

import numpy as np

import _golden

# case -> (EngineConfig section, field, value)
CASES = {"qd_limit": ("wbc", "qd_limit", True),
         "foothold_off": ("foothold", "enabled", False),
         "min_exit": ("apf", "min_exit", True),
         "rep_field_in_step": ("apf", "rep_field_in_step", True),
         "base_box": ("mpc", "base_box", True),
         "base_acc": ("mpc", "base_acc", True),
         "sqp_iters_2": ("mpc", "sqp_iters", 2),
         "ref_exact": ("wbc", "ref_exact", True),
         "early_td_off": ("gait", "early_td", False)}
B, SEED, CYCLES = 2, 0, 2
# case -> (n, seed, lanes) of the random_scenarios it runs on instead of
# the shared ones
FOOTHOLD_SCN = {"foothold_off": (16, 1, (0, 1))}
FOOTHOLD_MOVES = 1e-3      # rad in q: the option's run leaves the default's
OUT = Path(__file__).resolve().parent / "option_golden.npz"


def case_config(base, case):
    """`base` with the one field of `case` changed."""
    section, field, value = CASES[case]
    sub = getattr(base, section)
    assert getattr(sub, field) != value, (case, "is the default")
    return base.replace(**{section: dataclasses.replace(sub,
                                                        **{field: value})})


def run(dtype_name: str, path: str):
    dtype = _golden.jax_dtype(dtype_name)

    from apf_quadruped_tpu.__main__ import _cfg
    from apf_quadruped_tpu.runtime import sweep

    base = _cfg(Namespace(iters=15, robot="dogbot", gait="trot", sqp=1))
    shared = sweep.random_scenarios(base, B, seed=SEED, dtype=dtype,
                                    use_native=False)
    data = _golden.leaves("scn", shared)
    for case, (section, field, value) in CASES.items():
        cfg = case_config(base, case)
        data[f"case.{case}.{section}.{field}"] = np.asarray(value)
        scn = shared
        if case in FOOTHOLD_SCN:
            n, seed, lanes = FOOTHOLD_SCN[case]
            scn = type(shared)(*(v[np.asarray(lanes)] for v in
                                 sweep.random_scenarios(
                                     base, n, seed=seed, dtype=dtype,
                                     use_native=False)))
            data.update(_golden.leaves(f"scn_{case}", scn))
            if dtype_name == "f64":     # the default's run, to differ from
                st = sweep.init_batch(base, scn)
                for k in range(CYCLES):
                    st, m = sweep.step_batch(base, scn, st, 1)
                    data[f"on.{case}.c{k}.state.sim.q"] = np.asarray(
                        st.sim.q)
                    data[f"on.{case}.c{k}.metrics.foot_mu"] = np.asarray(
                        m.foot_mu)
        for name in _golden.runs_of(dtype_name):
            st = _golden.moved(sweep.init_batch(cfg, scn), name)
            for k in range(CYCLES):
                st, m = sweep.step_batch(cfg, scn, st, 1)
                data.update(_golden.leaves(f"{name}.{case}.c{k}.state", st))
                data.update(_golden.leaves(f"{name}.{case}.c{k}.metrics", m))
            print(f"{name} {case}: {CYCLES} cycles, R22 "
                  f"{np.asarray(st.sim.R_wb[:, 2, 2]).tolist()}", flush=True)
    _golden.save(path, data, dtype_name)


def check_foothold(data):
    """foothold_off's run leaves the default's on its scenarios: more than
    FOOTHOLD_MOVES apart in q after some cycle, in a lane where every
    float64 twin stays within 1e-6 of its run."""
    for case in FOOTHOLD_SCN:
        moved = False
        for k in range(CYCLES):
            key = f"{case}.c{k}.state.sim.q"
            off = data[f"f64.{key}"]
            apart = np.abs(data[f"on.{key}"] - off).max(axis=-1)
            spread = np.max([np.abs(data[f"{t}.{key}"] - off).max(axis=-1)
                             for t in _golden.TWINS], axis=0)
            moved |= bool(((apart > FOOTHOLD_MOVES) & (spread < 1e-6)).any())
            print(f"{case} c{k}: q apart from the default's {apart}, twins "
                  f"{spread}", flush=True)
        assert moved, f"{case}: the option's run equals the default's"


if __name__ == "__main__":
    _golden.main(OUT, __file__, run, check_foothold)
