"""The port's closed loop vs the JAX package under each opt-in option of
EngineConfig that changes a closed loop's result, on the CPU, in float64,
against tests/data/option_golden.npz (tests/data/make_option_golden.py)
with tests/test_torch_loop_modes.py's gates: the WBC's and the tick's
options here (wbc.qd_limit, wbc.ref_exact, gait.early_td off);
tests/test_torch_loop_options_plan.py runs the plan's (mpc.base_box,
mpc.base_acc, mpc.sqp_iters 2) and tests/test_torch_loop_options_nav.py
the navigation's (foothold.enabled off, apf.min_exit,
apf.rep_field_in_step), three a file.

Each case is the CLI's sweep configuration with exactly the one field the
golden names changed ("case.<case>.<section>.<field>"), B=2 scenarios
from random_scenarios(seed=0, use_native=False) (foothold_off: its own,
"scn_foothold_off.<field>"), 2 cycles through
sweep.init_batch / step_batch: the second runs trot pair B from the
first's leg-permuted warm start.
"""

import dataclasses
from pathlib import Path

import numpy as np
import pytest
import torch

from apf_quadruped_tpu_torch import convert
from apf_quadruped_tpu_torch.runtime import sweep
from chip_smoke import batch_cycles, option_config, option_scenarios
from test_torch_loop_modes import check_case

torch.set_num_threads(1)

GOLDEN = Path(__file__).resolve().parent / "data" / "option_golden.npz"
CASES = ("qd_limit", "foothold_off", "min_exit", "rep_field_in_step",
         "base_box", "base_acc", "sqp_iters_2", "ref_exact", "early_td_off")
CYCLES = 2
# (case, cycle) -> the flag and count leaves the f64p twin flips, and the
# float leaves beyond 5x its spread (tests/test_torch_loop_modes.py)
TWIN_FLIPS = {("qd_limit", 1): {"metrics.mpc_converged",
                                "metrics.mpc_iters"}}
BEYOND_F64P = {("qd_limit", 1): {"metrics.early_td_frac"}}


def load_golden():
    with np.load(GOLDEN) as f:
        return {k: f[k] for k in f.files}


def port_cycles(golden, case):
    """[(LoopState, CycleMetrics)] after each cycle of the port's float64
    run of `case` on the case's scenarios, one step_batch call a cycle as
    the golden was written (chip_smoke.batch_cycles, which phase 24 runs
    on the card)."""
    cycles, _ = batch_cycles(
        option_config(golden, case),
        option_scenarios(golden, case, "cpu", torch.float64), CYCLES)
    return [(st, m) for _, st, m in cycles]


def check(golden, runs, case, k):
    check_case(golden, runs, case, k, TWIN_FLIPS, BEYOND_F64P)


@pytest.fixture(scope="module")
def golden():
    return load_golden()


@pytest.fixture(scope="module")
def runs(golden):
    return {case: port_cycles(golden, case)
            for case in ("qd_limit", "ref_exact", "early_td_off")}


def test_golden_holds_each_option_alone(golden):
    """The golden's cases are the nine options, each one field away from
    the CLI's sweep configuration, on the CLI's scenarios
    (random_scenarios(n=2, seed=0)) but foothold_off, which runs on lanes
    0 and 1 of random_scenarios(n=16, seed=1)."""
    assert sorted(k.split(".")[1] for k in golden
                  if k.startswith("case.")) == sorted(CASES)
    base = dataclasses.asdict(sweep.cli_config())
    for case in CASES:
        cfg = dataclasses.asdict(option_config(golden, case))
        changed = [(s, f) for s in base for f in base[s]
                   if base[s][f] != cfg[s][f]]
        assert len(changed) == 1, (case, changed)
    for case, n, seed in (("qd_limit", 2, 0), ("foothold_off", 16, 1)):
        scn = sweep.random_scenarios(sweep.cli_config(), n, seed=seed,
                                     dtype=torch.float64, use_native=False,
                                     device="cpu")
        ours = option_scenarios(golden, case, "cpu", torch.float64)
        for name, v in scn._asdict().items():
            if v is None:       # flat ground: no height map on either
                assert getattr(ours, name) is None, (case, name)
                continue
            np.testing.assert_array_equal(convert.to_numpy(v)[:2],
                                          convert.to_numpy(getattr(ours,
                                                                   name)),
                                          err_msg=(case, name))


def test_wbc_velocity_rows_match_jax(rng):
    """wbc.qd_limit's rows of the WBC's QP against the JAX package's, on
    states whose joint velocities reach and pass RobotConfig.qd_max, where
    the rows bind (the solve of the QP is the default one, held by
    tests/test_torch_wbc_physics.py).  The closed loop under qd_limit
    falls within its first cycle in the JAX package itself (its WBC
    converges on ~25% of the ticks, as WbcConfig.qd_limit's comment says),
    so the golden's gates are as wide as its twins' spread there and hold
    little of these rows."""
    import jax.numpy as jnp

    from apf_quadruped_tpu import wbc as jwbc
    from apf_quadruped_tpu.config import WbcConfig as JWbcConfig
    from apf_quadruped_tpu_torch import wbc as twbc
    from apf_quadruped_tpu_torch.config import WbcConfig
    from test_torch_parity_inputs import CFG, JCFG, close, jv
    from test_torch_wbc_physics import _wbc_inputs

    st, ref = _wbc_inputs(rng, (0, 1, 0, 1))
    qd = rng.normal(size=st["u"][:, 6:18].shape) * 4.0
    qd[:, 0], qd[:, 5] = 7.0, -6.5        # past the limit: the clamp order
    st["u"] = np.concatenate([st["u"][:, :6], qd], axis=-1)
    wcfg = dict(slack_weight_trot=1e6, qd_limit=True)
    cfg_j = JCFG.replace(wbc=JWbcConfig(**wcfg))
    cfg_t = CFG.replace(wbc=WbcConfig(**wcfg))
    qp_j = jv(lambda s, r: jwbc._build_qp(cfg_j, s, r)[0])(
        jwbc.WbcState(**{k: jnp.asarray(v) for k, v in st.items()}),
        jwbc.WbcRefs(**{k: jnp.asarray(v) for k, v in ref.items()}))
    st_t, ref_t = convert.wbc_state(st), convert.wbc_refs(ref)
    qp_t, _ = twbc._build_qp(cfg_t, st_t, ref_t)
    for a, b in zip(qp_t, qp_j):
        close(a, b, 1e-9 * max(1.0, float(np.abs(np.asarray(b)).max())))
    off, _ = twbc._build_qp(CFG, st_t, ref_t)
    bind = convert.to_numpy(qp_t.h != off.h)[:, 44:]
    assert bind[:, :12].any() and bind[:, 12:].any()   # both row blocks


@pytest.mark.parametrize("case,k", [(c, k) for c in ("qd_limit", "ref_exact",
                                                     "early_td_off")
                                    for k in range(CYCLES)])
def test_cycle_matches_jax(golden, runs, case, k):
    check(golden, runs, case, k)
