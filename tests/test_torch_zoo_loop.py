"""The zoo robots' closed loops through the port vs the JAX package, on
the CPU, in float64.

Each robot's closed loop, the `run` command's (flat ground, target
(0, 1.5), one scenario, one 200-tick cycle), against the JAX package's
float64 run (tests/data/zoo_golden.npz, written by
tests/data/make_zoo_golden.py): flags and counts exactly, each float leaf
within 1e-6 (tests/test_torch_loop.py's gate) plus 5 times the distance
the JAX run itself moves when its start moves by 1e-14 m.  HyQ's 83 kg on
stiff penalty contact carries such a change to ~4e-4 in 200 ticks, so no
float64 run that sums in another order lands within 1e-6 of another.
"""

import dataclasses
from argparse import Namespace
from pathlib import Path

import numpy as np
import pytest
import torch

from apf_quadruped_tpu.__main__ import _cfg as jax_cli_cfg
from apf_quadruped_tpu_torch import __main__ as cli
from apf_quadruped_tpu_torch import convert
from apf_quadruped_tpu_torch.runtime import sweep

torch.set_num_threads(1)

GOLDEN = Path(__file__).resolve().parent / "data" / "zoo_golden.npz"


@pytest.fixture(scope="module")
def golden():
    with np.load(GOLDEN) as f:
        return {k: f[k] for k in f.files}


def _pairs(prefix, tree, golden):
    for name, value in tree._asdict().items():
        key = f"{prefix}.{name}"
        if hasattr(value, "_asdict"):
            yield from _pairs(key, value, golden)
        elif value is not None:
            yield key, convert.to_numpy(value), golden[key]


@pytest.mark.parametrize("name", ["anymal", "hyq"])
def test_closed_loop_matches_jax_golden(golden, name):
    args = Namespace(iters=15, robot=name, gait="trot", sqp=1)
    cfg = cli._cfg(args)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jax_cli_cfg(args))
    st, m, _, _ = cli.run_closed_loop(cfg, target="0,1.5", cycles=1,
                                      dtype=torch.float64, device="cpu")
    n = 0
    for prefix, tree in (("state", st), ("metrics", m)):
        for key, port, ref in _pairs(f"f64.{name}.{prefix}", tree, golden):
            assert port.shape == ref.shape and port.dtype == ref.dtype, key
            if ref.dtype.kind in "bi":
                np.testing.assert_array_equal(port, ref, err_msg=key)
            else:
                spread = np.abs(golden["f64p" + key[3:]] - ref).max()
                np.testing.assert_allclose(port, ref, rtol=0,
                                           atol=1e-6 + 5 * spread,
                                           err_msg=key)
            n += 1
    assert n == len([k for k in golden if k.startswith(f"f64.{name}.")])
    assert n == len([k for k in golden if k.startswith(f"f64p.{name}.")])
    assert float(m.com[0, -1, 1]) > 0.0 and float(st.sim.R_wb[0, 2, 2]) > 0.98
    assert sweep.cli_config(robot=name) == cfg
