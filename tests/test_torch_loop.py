"""The port's batched closed loop vs the JAX package, on the CPU.

tests/data/loop_golden.npz holds the JAX package's sweep (init_batch +
step_batch and run_batch) at the CLI's sweep configuration: B=4 scenarios
from random_scenarios(seed=0, use_native=False), one replan cycle of 200
ticks (tests/data/make_loop_golden.py).  The port runs the same scenarios
in float64 here.  Tolerances: the final state and the per-cycle metrics
within 1e-6 (positions in m, velocities in m/s or rad/s, wrench estimates
in N), the plan's and the WBC's convergence flags and iteration counts
exactly.  Two float64 runs of the same loop differ only by the summation
order of their reductions; over 200 ticks of a stiff penalty contact that
grows from 1e-15 to ~1e-9 (measured: max 6.5e-10, on qdd_max in
rad/s^2).  A discrete choice that rounding decides would break this: the
knot index of tick 30 is one (loop.py, knot_ratio).

The crawl, adaptive and fixed-stride gait modes run here without JAX: a
short crawl cycle stays upright and keeps its unpermuted warm start.
"""

from pathlib import Path

import numpy as np
import pytest
import torch

from apf_quadruped_tpu_torch import convert
from apf_quadruped_tpu_torch.config import (EngineConfig, GaitConfig,
                                            MpcConfig)
from apf_quadruped_tpu_torch.runtime import loop, sweep
from apf_quadruped_tpu_torch.sim import disturbance, terrain

torch.set_num_threads(1)

GOLDEN = Path(__file__).resolve().parent / "data" / "loop_golden.npz"
ATOL = 1e-6


@pytest.fixture(scope="module")
def golden():
    with np.load(GOLDEN) as f:
        return {k: f[k] for k in f.files}


@pytest.fixture(scope="module")
def port_run(golden):
    cfg = sweep.cli_config()
    scn = convert.unflatten(golden, "scn", sweep.Scenario)
    states, metrics = sweep.step_batch(cfg, scn, sweep.init_batch(cfg, scn),
                                       1)
    return scn, states, metrics, sweep.result(scn, states, metrics)


def _pairs(prefix, tree, golden):
    for name, value in tree._asdict().items():
        key = f"{prefix}.{name}"
        if hasattr(value, "_asdict"):
            yield from _pairs(key, value, golden)
        elif value is not None:
            yield key, convert.to_numpy(value), golden[key]


def test_scenarios_match_jax_generator(golden):
    cfg = sweep.cli_config()
    scn = sweep.random_scenarios(cfg, 4, seed=0, dtype=torch.float64,
                                 use_native=False, device="cpu")
    for key, port, ref in _pairs("scn", scn, golden):
        np.testing.assert_array_equal(port, ref, err_msg=key)


def test_final_state_matches_jax(port_run, golden):
    _, states, _, _ = port_run
    for key, port, ref in _pairs("f64.state", states, golden):
        assert port.dtype == ref.dtype, key
        np.testing.assert_allclose(port, ref, rtol=0, atol=ATOL,
                                   err_msg=key)


def test_cycle_metrics_match_jax(port_run, golden):
    _, _, metrics, _ = port_run
    for key, port, ref in _pairs("f64.metrics", metrics, golden):
        assert port.shape == ref.shape, key
        if ref.dtype.kind in "bi":
            np.testing.assert_array_equal(port, ref, err_msg=key)
        else:
            np.testing.assert_allclose(port, ref, rtol=0, atol=ATOL,
                                       err_msg=key)


def test_sweep_result_matches_jax(port_run, golden):
    _, _, _, res = port_run
    for name, value in res._asdict().items():
        if name == "metrics":
            continue
        np.testing.assert_allclose(convert.to_numpy(value),
                                   golden[f"f64.result.{name}"], rtol=0,
                                   atol=ATOL, err_msg=name)
    assert not res.fell.any()
    assert float(res.qp_converged.mean()) > 0.9


def test_gait_schedules():
    """Every gait mode's flag, crawl state and cycle length per lane."""
    def sched(mode, cycle_idx, crawling, rob):
        cfg = EngineConfig(gait=GaitConfig(mode=mode))
        st = loop.init(cfg, 3, dtype=torch.float64, device="cpu")
        st = st._replace(cycle_idx=torch.tensor(cycle_idx, dtype=torch.int32),
                         crawling=torch.tensor(crawling))
        ast = st.apf._replace(rob_foot=torch.tensor(rob, dtype=torch.float64)
                              [:, None].expand(3, 4))
        flag, crawl, cycle = loop._gait_schedule(cfg, st, ast)
        return flag.tolist(), crawl.tolist(), cycle

    assert sched("trot", [0, 1, 4], [False] * 3, [0.5] * 3) == \
        ([1, 2, 1], [False] * 3, 0.5)
    assert sched("crawl", [0, 1, 2], [True] * 3, [0.5] * 3) == \
        ([4, 4, 4], [True] * 3, 1.0)
    assert sched("pace", [0, 1, 2], [False] * 3, [0.5] * 3) == \
        ([18, 18, 18], [False] * 3, 0.5)
    # adaptive: enter below 0.20, stay until above 0.28
    assert sched("adaptive", [0, 0, 0], [False, True, True],
                 [0.1, 0.25, 0.3]) == ([4, 4, 15], [True, True, False], 1.0)
    with pytest.raises(ValueError, match="bogus"):
        sched("bogus", [0, 0, 0], [False] * 3, [0.5] * 3)


def test_crawl_cycle_runs():
    """A short crawl cycle (one leg at a time, 0.2 s, 80 ticks): upright,
    converged, the warm start stored for the same flag, unpermuted."""
    cfg = EngineConfig(gait=GaitConfig(mode="crawl", crawl_cycle=0.2),
                       mpc=MpcConfig(horizon=8, dt=0.025))
    st = loop.init(cfg, 1, dtype=torch.float64, device="cpu")
    terr = terrain.flat(cfg.sim, batch=(1,), dtype=torch.float64)
    st2, m = loop.run(cfg, st, terr, torch.tensor([[0.0, 1.0]],
                                                  dtype=torch.float64),
                      disturbance.empty(torch.float64)[None], 1)
    assert bool(m.crawling.all()) and bool(m.mpc_converged.all())
    assert float(st2.sim.R_wb[0, 2, 2]) > 0.98
    assert int(st2.warm_flag[0]) == 4 and bool(st2.warm_valid[0])
    assert float(m.qp_converged.mean()) > 0.9
    assert bool(torch.isfinite(st2.sim.q).all())


def test_sweep_command_runs(capsys):
    """`python -m apf_quadruped_tpu_torch sweep` on one scenario, one cycle
    (the CPU here: the plain versions of the kernels)."""
    from apf_quadruped_tpu_torch.__main__ import main
    main(["sweep", "--batch", "1", "--cycles", "1", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "scenarios=1 cycles=1 device=cpu" in out and "fell=0" in out
