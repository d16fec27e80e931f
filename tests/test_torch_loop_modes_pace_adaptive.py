"""The port's closed loop vs the JAX package in the pace (a fixed stride
of gait.NAMED_MODE_FLAGS) and adaptive gait modes, on the CPU, in
float64, against tests/data/mode_golden.npz with
tests/test_torch_loop_modes.py's gates.

Adaptive's second cycle: the robot falls in both lanes, and the JAX run
itself moves up to ~9 rad in q and ~1.5 in R when its start moves by
1e-12 rad, so the spread gate says little of that cycle's floats.  What
is held exactly there is the decision the cycle makes at its head from
cycle 0's robustness EWMA: trot (flag 15) or crawl (flag 4), per lane.
"""

import numpy as np
import pytest
import torch

from apf_quadruped_tpu_torch import convert
from test_torch_loop_modes import check_case, load_golden, port_cycles

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def golden():
    return load_golden()


@pytest.fixture(scope="module")
def runs(golden):
    return {case: port_cycles(golden, case) for case in ("pace", "adaptive")}


@pytest.mark.parametrize("case,k", [("pace", 0), ("pace", 1),
                                    ("adaptive", 0), ("adaptive", 1)])
def test_cycle_matches_jax(golden, runs, case, k):
    check_case(golden, runs, case, k)


def test_adaptive_cycle1_gait_decision(golden, runs):
    st, m = runs["adaptive"][1]
    for key, port in (("metrics.crawling", m.crawling),
                      ("state.crawling", st.crawling),
                      ("state.warm_flag", st.warm_flag)):
        np.testing.assert_array_equal(
            convert.to_numpy(port), golden[f"f64.adaptive.c1.{key}"],
            err_msg=key)
