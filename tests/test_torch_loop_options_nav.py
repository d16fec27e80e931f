"""The port's closed loop vs the JAX package under the navigation's
opt-in options (foothold.enabled=False: the APF step targets as they are;
apf.min_exit; apf.rep_field_in_step), on the CPU, in float64, against
tests/data/option_golden.npz with tests/test_torch_loop_options.py's
helpers and tests/test_torch_loop_modes.py's gates.  foothold_off runs on
scenarios of its own, where the option moves a step target off a patch
of low friction in cycle 1 (tests/data/make_option_golden.py);
test_golden_foothold_off_moves_a_step fails if a regenerated golden
stops moving one."""

import numpy as np
import pytest
import torch

from test_torch_loop_options import CYCLES, check, load_golden, port_cycles

torch.set_num_threads(1)

CASES = ("foothold_off", "min_exit", "rep_field_in_step")


@pytest.fixture(scope="module")
def golden():
    return load_golden()


@pytest.fixture(scope="module")
def runs(golden):
    return {case: port_cycles(golden, case) for case in CASES}


@pytest.mark.parametrize("case,k", [(c, k) for c in CASES
                                    for k in range(CYCLES)])
def test_cycle_matches_jax(golden, runs, case, k):
    check(golden, runs, case, k)


def test_golden_foothold_off_moves_a_step(golden):
    """On the golden itself: with foothold.enabled=False the JAX float64
    run leaves the default's on the case's scenarios, more than 1e-3 rad
    apart in q after some cycle in a lane where every float64 twin stays
    within 1e-6 of its run, so a fault in that branch cannot pass."""
    moved = False
    for k in range(CYCLES):
        key = f"foothold_off.c{k}.state.sim.q"
        off = golden[f"f64.{key}"]
        apart = np.abs(golden[f"on.{key}"] - off).max(axis=-1)
        spread = np.max([np.abs(golden[f"{t}.{key}"] - off).max(axis=-1)
                         for t in ("f64p", "f64m", "f64b")], axis=0)
        moved |= bool(((apart > 1e-3) & (spread < 1e-6)).any())
    assert moved
