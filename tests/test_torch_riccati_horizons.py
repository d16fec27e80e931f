"""The port's plain stage-QP IPM against the JAX package's at the shapes
the resident kernel's card tests stress (tests/test_torch_cuda.py): one
knot and a long horizon, H = 1 and 30, at production widths (13 states,
12 inputs, 24 rows) with 6 state rows and the accel rows.  With the card
tests this closes the chain kernel -> plain version -> JAX scan at those
shapes.  Gates are tests/test_torch_riccati.py's: converged and iters
exactly equal, u/x at atol 5e-5 in float32 and 1e-9 in float64.  The
dynamics are A_k = I + 0.03 N (problems.random_stage_qp's a_noise): with
the default 0.1, thirty knots spread them so far that float32 rounding
alone moves a lane's stopping iteration.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_riccati import ATOL, CFG, _assert_same, _jax_qp, _jax_warm, _warm

from apf_quadruped_tpu.ops import riccati as jr
from apf_quadruped_tpu_torch import convert, problems
from apf_quadruped_tpu_torch.ops import riccati as tr

torch.set_num_threads(1)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("H", [1, 30])
@pytest.mark.parametrize("has_warm", [False, True])
def test_plain_matches_jax_scan_production_widths(rng, has_warm, H, dtype):
    q = problems.random_stage_qp(rng, H=H, NX=13, NU=12, M=24, mc=6,
                                 acc=True, dtype=dtype, a_noise=0.03)
    warm = None
    if has_warm:
        cold = jr.solve_stage_qp(_jax_qp(q), CFG)
        warm = _warm(cold, [True, False, True, True])
    ref = jr.solve_stage_qp(_jax_qp(q), CFG, warm=_jax_warm(warm))
    assert np.asarray(ref.converged).all()
    out = tr.solve_stage_qp(convert.stage_qp(q), CFG,
                            None if warm is None else convert.warm_start(warm))
    assert out.u.dtype == {np.float32: torch.float32,
                           np.float64: torch.float64}[dtype]
    _assert_same(ref, out, ATOL[dtype])
