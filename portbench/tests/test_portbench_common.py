"""The comparison's arithmetic on hand-made numbers: the share of a
cycle's change by which an end state misses, and the iterations by which
a solve stopped early."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from portbench import common


def test_change_ratios_by_hand():
    start = torch.zeros(3, 2)
    ref = torch.tensor([[1.0, 0.0], [0.0, -2.0], [0.5, 0.5]])
    judged = torch.tensor([[1.1, 0.0], [0.0, -2.0], [0.0, 0.0]])
    r = common.change_ratios([judged], [ref], [start], floor=0.0)
    assert r.shape == (1, 3)
    # 0.1 of a move of 1; no miss; left at the start: 1
    np.testing.assert_allclose(r[0], [0.1, 0.0, 1.0], rtol=1e-6)
    r = common.change_ratios([start], [ref], [start], floor=1e-6)
    np.testing.assert_allclose(r[0], 1.0, rtol=1e-5)


@pytest.mark.parametrize("own, judged, short", [
    ([7, 8, 9], [7, 8, 9], 0), ([7, 8, 9], [8, 9, 10], 0),
    ([7, 8, 9], [7, 5, 9], 3), ([7, 8, 9], [1, 1, 1], 8)])
def test_iters_short_by_hand(own, judged, short):
    assert common.iters_short(torch.tensor(own), torch.tensor(judged)) \
        == short
