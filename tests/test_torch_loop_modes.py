"""The port's closed loop vs the JAX package in every gait mode of the
command line and across replan cycles, on the CPU, in float64: the trot
and crawl cases (tests/test_torch_loop_modes_pace_adaptive.py runs the
pace and adaptive cases with the helpers here, each file ~45 s).

tests/data/mode_golden.npz (tests/data/make_mode_golden.py) holds the JAX
package's sweep at the CLI's configuration per mode, B=2 scenarios from
random_scenarios(seed=0, use_native=False), run cycle by cycle: trot 3
cycles (pair A, pair B with the leg-permuted warm start, pair A), crawl 1
(H=40), pace 2 (a fixed stride, the warm start unpermuted) and adaptive 2
(the in-loop trot <-> crawl switch).  The port runs the same scenarios
cycle by cycle through sweep.init_batch / step_batch on the CPU.

Gates, per leaf of every cycle's LoopState and CycleMetrics:
  * floats: max |port - JAX| <= 1e-6 + 5 max |JAX - JAX'|, where JAX' is
    the golden's "f64p" run, the JAX loop from a start whose joint angles
    moved by 1e-12 rad.  Stiff penalty contact, slip and the discrete
    choices of the loop carry such a rounding far: to ~1e-4 in q in trot's
    second cycle, ~1e-2 in a crawl or pace cycle.  A port that sums in
    another order cannot land closer than the loop's own spread.  Where a
    mode turns chaotic one twin is one sample of that spread: a leaf
    beyond 5x its distance is held to 1.5x the farthest of the golden's
    three twins (f64p, f64m: q moved by -1e-12 rad, f64b: the base by
    1e-14 m), about the most its readings need (the port sits at
    0.26-1.08x that twin), and BEYOND_F64P names each such leaf;
  * flags and counts (the plan's and the WBC's convergence, mpc_iters,
    the fall, contact and crawl flags, the gait flag): exactly, in every
    cycle where JAX' keeps them equal to JAX.  A leaf that JAX' itself
    flips falls back to the float gate; TWIN_FLIPS names each one.
The test fails if a leaf leaves or joins either list.  chip_smoke.py
phase 23 holds the card's float32 run to the same TWIN_FLIPS.
"""

import ast
import functools
from pathlib import Path

import numpy as np
import pytest
import torch

from apf_quadruped_tpu_torch import convert
from apf_quadruped_tpu_torch.runtime import sweep

torch.set_num_threads(1)

GOLDEN = Path(__file__).resolve().parent / "data" / "mode_golden.npz"
CASES = {"trot": 3, "crawl": 1, "pace": 2, "adaptive": 2}
SPREAD_FACTOR, BEYOND_FACTOR, ATOL = 5.0, 1.5, 1e-6
TWINS = ("f64p", "f64m", "f64b")
# (case, cycle) -> the flag and count leaves the f64p twin flips
TWIN_FLIPS = {("adaptive", 1): {"metrics.mpc_iters"}}
# (case, cycle) -> the float leaves beyond 5x the f64p twin's spread and
# within 1.5x the farthest twin's (port, f64p and farthest twin distances
# in ROADMAP.md queue 3)
BEYOND_F64P = {("adaptive", 0): {"metrics.early_td_frac"},
               ("pace", 1): {"metrics.early_td_frac", "metrics.wrench_peak",
                             "state.sim.u"}}


def load_golden():
    with np.load(GOLDEN) as f:
        return {k: f[k] for k in f.files}


def port_cycles(golden, case):
    """The port's float64 run of `case`: [(LoopState, CycleMetrics)] after
    each cycle, one step_batch call a cycle as the golden was written."""
    cfg = sweep.cli_config(gait=case)
    scn = convert.unflatten(golden, "scn", sweep.Scenario)
    st = sweep.init_batch(cfg, scn)
    out = []
    for _ in range(CASES[case]):
        st, m = sweep.step_batch(cfg, scn, st, 1)
        out.append((st, m))
    return out


def _pairs(prefix, tree):
    for name, value in tree._asdict().items():
        key = f"{prefix}.{name}"
        if hasattr(value, "_asdict"):
            yield from _pairs(key, value)
        elif value is not None:
            yield key, convert.to_numpy(value)


def gate_cycle(golden, case, k, st, m):
    """Hold cycle k of `case` to the golden.  Returns (the leaves that miss
    their gate, with the numbers; the flag and count leaves the f64p twin
    flips; the float leaves beyond its gate; the worst port / f64p-gate
    ratio and its leaf)."""
    head = f"f64.{case}.c{k}."
    misses, flipped, beyond, worst, n = [], set(), set(), (0.0, ""), 0
    for prefix, tree in (("state", st), ("metrics", m)):
        for key, port in _pairs(head + prefix, tree):
            ref, twin = golden[key], golden["f64p" + key[3:]]
            leaf = key[len(head):]
            assert port.shape == ref.shape and port.dtype == ref.dtype, key
            n += 1
            exact = ref.dtype.kind in "bi"
            if exact and np.array_equal(ref, twin):
                if not np.array_equal(port, ref):
                    misses.append(f"{leaf}: port {port.tolist()} != JAX "
                                  f"{ref.tolist()}")
                continue
            if exact:
                flipped.add(leaf)
            ref = ref.astype(np.float64)
            diff = float(np.abs(port.astype(np.float64) - ref).max())
            spread = [float(np.abs(golden[t + key[3:]] - ref).max())
                      for t in TWINS]
            gate = ATOL + SPREAD_FACTOR * spread[0]
            worst = max(worst, (diff / gate, leaf))
            if diff > gate:
                beyond.add(leaf)
                gate = ATOL + BEYOND_FACTOR * max(spread)
            if not diff <= gate:
                misses.append(f"{leaf}: max|port - JAX| {diff:.3g} > gate "
                              f"{gate:.3g} (twins {spread})")
    assert n == len([k for k in golden if k.startswith(head)])
    return misses, flipped, beyond, worst


def check_case(golden, runs, case, k, twin_flips=TWIN_FLIPS,
               beyond_f64p=BEYOND_F64P):
    """Cycle k of `case` within its gates, with exactly the leaves that
    `twin_flips` and `beyond_f64p` name for it (another golden's tests pass
    their own lists)."""
    st, m = runs[case][k]
    misses, flipped, beyond, worst = gate_cycle(golden, case, k, st, m)
    tree = {"state": st, "metrics": m}

    def distances(leaf):
        """max |port - JAX| and each twin's, of one leaf."""
        prefix, *path = leaf.split(".")
        port = convert.to_numpy(functools.reduce(getattr, path,
                                                 tree[prefix]))
        ref = golden[f"f64.{case}.c{k}.{leaf}"]
        return " / ".join(f"{np.abs(v - ref).max():.3g}" for v in [port] + [
            golden[f"{t}.{case}.c{k}.{leaf}"] for t in TWINS])

    print(f"{case} cycle {k}: max|q - JAX|, port / twins "
          f"{distances('state.sim.q')}; worst port / f64p gate "
          f"{worst[0]:.3g} ({worst[1]})")
    for leaf in sorted(beyond):
        print(f"  beyond: {leaf}, port / twins {distances(leaf)}")
    assert not misses, f"{case} cycle {k}:\n" + "\n".join(misses)
    assert flipped == twin_flips.get((case, k), set()), flipped
    assert beyond == beyond_f64p.get((case, k), set()), beyond


@pytest.fixture(scope="module")
def golden():
    return load_golden()


@pytest.fixture(scope="module")
def runs(golden):
    return {case: port_cycles(golden, case) for case in ("trot", "crawl")}


def test_scenarios_match_jax_generator(golden):
    cfg = sweep.cli_config()
    scn = sweep.random_scenarios(cfg, 2, seed=0, dtype=torch.float64,
                                 use_native=False, device="cpu")
    for key, port in _pairs("scn", scn):
        np.testing.assert_array_equal(port, golden[key], err_msg=key)


@pytest.mark.parametrize("case,k", [("trot", 0), ("trot", 1), ("trot", 2),
                                    ("crawl", 0)])
def test_cycle_matches_jax(golden, runs, case, k):
    check_case(golden, runs, case, k)



def test_chip_smoke_holds_the_same_twin_flips():
    """chip_smoke.py phase 23 leaves out on the card exactly the flags
    this file leaves out on the CPU."""
    tree = ast.parse((Path(__file__).resolve().parents[1]
                      / "chip_smoke.py").read_text())
    found = [ast.literal_eval(node.value) for node in tree.body
             if isinstance(node, ast.Assign)
             and [getattr(t, "id", None) for t in node.targets]
             == ["TWIN_FLIPS"]]
    assert found == [TWIN_FLIPS]
