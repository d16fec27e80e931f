"""On the card: each cell's control, the plain reference put in the
program's place one precision below the configuration's (TF32 on), fails
a number its limit holds (a sweep's control is its cycle's plan, which
`plan_ratio` judges), and the program passes them all; at sizes a
test run holds (the cells' own sizes are read by portbench/control.py,
PERF.md).  Skipped without a card; run on the card with
`python -m pytest portbench/tests/test_portbench_card.py`."""

from __future__ import annotations

import pytest
import torch

from portbench import harness

from . import small

CARD_SIZES = {
    "sweep": dict(batch=64),
    "plan": dict(batch=256, check_lanes=32),
    "realtime": dict(pool=8, check_calls=8),
}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (the program's CUDA kernels and "
                    "graphs, the control's TF32)")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("name", small.WORKLOADS)
def test_control_fails_and_program_passes(card, name):
    cell = small.cell(name)
    cell = cell._replace(traffic={**cell.traffic,
                                  **CARD_SIZES[cell.traffic["kind"]]})
    run = harness.Run(cell=cell, seed=777, seconds=2.0, trace=False,
                      device=card, control=True)
    rnr = harness.runner(run)
    rnr.traffic()
    rnr.warm()
    rnr.window()
    rnr.release()
    limits = {k: v for k, v in cell.limits.items() if k != "floor"}
    program = rnr.check()
    assert all(program[k] <= v for k, v in limits.items()), program
    control = rnr.judge(*rnr.control())
    assert any(control[k] > v for k, v in limits.items() if k in control), \
        control
