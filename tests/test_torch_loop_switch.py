"""The port's closed loop vs the JAX package where the adaptive gait mode
switches one lane of a batch into crawl while the other lane trots, on
the CPU, in float64, against tests/data/switch_golden.npz
(tests/data/make_switch_golden.py) with tests/test_torch_loop_modes.py's
gates.

The golden's B=2 lanes at the CLI's adaptive configuration (H=40, 1 s
cycles), 3 cycles, no pushes: lane 0 on a patch of mu 0.6 enters crawl at
cycle 2's head (gait flag 15 -> 4, its warm start discarded), lane 1
starts in crawl, leaves it at cycle 0's head and trots on with a valid
warm start.  So cycle 2 runs what no other golden reaches: lanes that
differ in `crawling` (the WBC's per-lane crawl weight and masks, the
tensor branch of wbc.solve's layout) and a warm start valid in one lane
only.  test_golden_reaches_the_switch fails if a regenerated golden stops
reaching these branches.
"""

import ast
from pathlib import Path

import numpy as np
import pytest
import torch

import chip_smoke
from apf_quadruped_tpu_torch import apf, convert
from apf_quadruped_tpu_torch.runtime import loop, sweep
from chip_smoke import batch_cycles
from test_torch_loop_modes import check_case

torch.set_num_threads(1)

GOLDEN = Path(__file__).resolve().parent / "data" / "switch_golden.npz"
CASE, CYCLES = "switch", 3
# (case, cycle) -> the flag and count leaves the f64p twin flips, and the
# float leaves beyond 5x its spread (tests/test_torch_loop_modes.py)
TWIN_FLIPS = {("switch", 1): {"metrics.mpc_iters"},
              ("switch", 2): {"metrics.mpc_iters"}}
BEYOND_F64P = {("switch", 1): {"metrics.com_err"}}


@pytest.fixture(scope="module")
def golden():
    with np.load(GOLDEN) as f:
        return {k: f[k] for k in f.files}


def port_cycles(golden):
    """[the LoopState before the cycle, after it, the CycleMetrics] of each
    cycle of the port's float64 run, one step_batch call a cycle
    (chip_smoke.batch_cycles, which phase 24 runs on the card)."""
    cycles, _ = batch_cycles(
        sweep.cli_config(gait="adaptive"),
        convert.unflatten(golden, "scn", sweep.Scenario), CYCLES,
        torch.as_tensor(golden["init.crawling"]))
    return cycles


@pytest.fixture(scope="module")
def cycles(golden):
    return port_cycles(golden)


def _f64(golden, k, leaf):
    return golden[f"f64.{CASE}.c{k}.{leaf}"]


def test_golden_reaches_the_switch(golden):
    """On the golden itself: a lane enters crawl after cycle 0 with its
    warm flag going 15 -> 4 (the valid trot warm start discarded), a lane
    leaves crawl, and a cycle has lanes that differ in `crawling`."""
    before = golden["init.crawling"]
    flag_before = np.zeros_like(before, dtype=np.int32)
    valid_before = np.zeros_like(before)
    enters = leaves = differ = False
    for k in range(CYCLES):
        crawl = _f64(golden, k, "metrics.crawling")[:, 0]
        flag = _f64(golden, k, "state.warm_flag")
        np.testing.assert_array_equal(crawl, _f64(golden, k,
                                                  "state.crawling"))
        enters |= bool((k > 0) & (crawl & ~before & valid_before
                                  & (flag_before == 15) & (flag == 4)).any())
        leaves |= bool((before & ~crawl).any())
        differ |= bool(crawl.any() and not crawl.all())
        before, flag_before = crawl, flag
        valid_before = _f64(golden, k, "state.warm_valid")
    assert enters and leaves and differ


@pytest.mark.parametrize("k", range(CYCLES))
def test_cycle_matches_jax(golden, cycles, k):
    runs = {CASE: [(st2, m) for _, st2, m in cycles]}
    check_case(golden, runs, CASE, k, TWIN_FLIPS, BEYOND_F64P)


def test_gait_decisions_match_jax_exactly(golden, cycles):
    """crawling, the warm flag and the cycle's gait flag equal the JAX
    float64 run's in every cycle and lane (adaptive stores the warm start
    for the cycle's own flag, so the golden's warm_flag is the gait
    flag)."""
    cfg = sweep.cli_config(gait="adaptive")
    for k, (st, st2, m) in enumerate(cycles):
        flag, crawling, _ = loop._gait_schedule(
            cfg, st, apf.update_robustness(cfg.apf, st.apf))
        for name, port in (("metrics.crawling", m.crawling[:, 0]),
                           ("state.crawling", st2.crawling),
                           ("state.crawling", crawling),
                           ("state.warm_flag", st2.warm_flag),
                           ("state.warm_flag", flag)):
            ref = _f64(golden, k, name)
            np.testing.assert_array_equal(convert.to_numpy(port),
                                          ref[:, 0] if ref.ndim == 2
                                          else ref, err_msg=(k, name))


def test_chip_smoke_holds_the_same_twin_flips():
    """chip_smoke.py phase 24 leaves out on the card exactly the flags that
    the switch, world and option tests leave out on the CPU."""
    import test_torch_loop_options
    import test_torch_loop_worlds

    tree = ast.parse((Path(__file__).resolve().parents[1]
                      / "chip_smoke.py").read_text())
    found = [ast.literal_eval(node.value) for node in tree.body
             if isinstance(node, ast.Assign)
             and [getattr(t, "id", None) for t in node.targets]
             == ["TWIN_FLIPS_24"]]
    assert found == [{**TWIN_FLIPS, **test_torch_loop_worlds.TWIN_FLIPS,
                      **test_torch_loop_options.TWIN_FLIPS}]


def test_chip_smoke_holds_every_gait_decision(golden):
    """chip_smoke.py phase 24 holds the card's crawl decision and warm flag
    to JAX float32's in every cycle and lane of the golden, the chaotic
    lanes too (held_decisions), at make_switch_golden.py's margin."""
    tree = ast.parse((Path(__file__).resolve().parent / "data"
                      / "make_switch_golden.py").read_text())
    margin = [ast.literal_eval(node.value) for node in tree.body
              if isinstance(node, ast.Assign)
              and [getattr(t, "id", None) for t in node.targets]
              == ["MARGIN"]]
    assert margin == [chip_smoke.DECISION_MARGIN]
    assert chip_smoke.held_decisions(golden, CASE) == [
        (k, b) for k in range(CYCLES) for b in range(2)]
