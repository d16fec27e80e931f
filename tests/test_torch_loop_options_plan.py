"""The port's closed loop vs the JAX package under the plan's opt-in
options (mpc.base_box: the base's state rows; mpc.base_acc: its
acceleration rows, carried unpermuted across the mirrored trot pair's warm
start; mpc.sqp_iters=2), on the CPU, in float64, against
tests/data/option_golden.npz with tests/test_torch_loop_options.py's
helpers and tests/test_torch_loop_modes.py's gates."""

import pytest
import torch

from test_torch_loop_options import CYCLES, check, load_golden, port_cycles

torch.set_num_threads(1)

CASES = ("base_box", "base_acc", "sqp_iters_2")


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
