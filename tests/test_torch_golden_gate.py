"""chip_smoke.py's gate on the card's float32 closed loop (golden_gate,
phases 9(c), 16, 23 and 24), on the CPU: the spread it allows is the
largest of the golden's samples of how far the loop carries a rounding
(JAX float32 against float64, each float64 twin against float64, each
float32 twin against float32), and a share of ticks moves by whole ticks.
The closed-loop goldens hold the float32 twins (tests/data/_golden.py
F32_TWINS) that the gate reads, and in the cases where a rounding decides
a branch one of them lies beyond the float32-against-float64 gate alone.
"""

from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import chip_smoke

DATA = Path(__file__).resolve().parent / "data"
GOLDENS = ("mode", "switch", "world", "option")


def _golden(**runs):
    """A golden of one metric leaf "f<run>.c.c0.metrics.v" per run."""
    return {f"{run}.c.c0.metrics.v": np.asarray(v) for run, v in runs.items()}


def _gate(g, port, ticks=None, leaf="v"):
    """golden_gate's worst (diff / gate) for `port` as the leaf's value."""
    g = {k.replace(".v", f".{leaf}"): v for k, v in g.items()}
    tree = SimpleNamespace(**{leaf: torch.as_tensor(port)})
    return chip_smoke.golden_gate(g, "c.c0.", {"metrics": tree},
                                  ticks=ticks)[0]


@pytest.mark.parametrize("name", GOLDENS)
def test_closed_loop_goldens_hold_float32_twins(name):
    """Every float32 leaf of the closed-loop goldens has its three float32
    twins, of its dtype and shape, and the twins start one ulp away."""
    with np.load(DATA / f"{name}_golden.npz") as f:
        g = {k: f[k] for k in f.files}
    leaves = [k[len("f32"):] for k in g if k.startswith("f32.")]
    assert leaves
    for twin in chip_smoke.F32_TWINS:
        for leaf in leaves:
            a, b = g["f32" + leaf], g[twin + leaf]
            assert (a.dtype, a.shape) == (b.dtype, b.shape), (twin, leaf)
        assert len([k for k in g if k.startswith(twin + ".")]) == len(leaves)


@pytest.mark.parametrize("twin", ["f64p", "f64m", "f64b",
                                  "f32p", "f32m", "f32b"])
def test_gate_takes_the_widest_twin(twin):
    """A twin 0.1 from its run widens the gate to 5 x 0.1 (+ 1e-4 (1 +
    |f64|)): a port at 0.45 from JAX float32 passes, at 0.55 fails."""
    base = dict(f64=[1.0], f32=[1.0001])
    twins = {t: ([1.0] if t.startswith("f64") else [1.0001])
             for t in chip_smoke.F64_TWINS + chip_smoke.F32_TWINS}
    ref = 1.0 if twin.startswith("f64") else 1.0001
    twins[twin] = [ref + 0.1]
    g = _golden(**base, **twins)
    assert _gate(g, [1.0001 + 0.45]) < 1.0
    with pytest.raises(RuntimeError, match="port vs JAX float32"):
        _gate(g, [1.0001 + 0.55])


def test_gate_without_twins_is_five_times_float32_from_float64():
    """A golden without twins (the loop and zoo goldens' float32 leaves)
    keeps 5 |JAX f32 - JAX f64| + 1e-4 (1 + |JAX f64|)."""
    g = _golden(f64=[2.0], f32=[2.001])
    gate = 5 * 0.001 + 1e-4 * 3.0
    assert _gate(g, [2.001 + 0.99 * gate]) < 1.0
    with pytest.raises(RuntimeError):
        _gate(g, [2.001 + 1.01 * gate])


def test_share_of_ticks_moves_by_whole_ticks():
    """With the cycle's ticks a share may move by one tick, though JAX's
    float32 share of 198 ticks of 200 (0.98999995, early_td_off's in
    option_golden.npz) and the port's 199 (0.995) lie 0.0050000047
    apart; two ticks fail where the twins and float64 agree."""
    jax198, port199 = np.float32(0.98999995), np.float32(0.995)
    g = _golden(f64=[0.99], f32=[jax198],
                **{t: [jax198] for t in chip_smoke.F32_TWINS})
    assert float(port199) - float(jax198) > 1.0 / 200
    assert _gate(g, [port199], ticks=200, leaf="qp_converged") <= 1.0
    with pytest.raises(RuntimeError):
        _gate(g, [np.float32(1.0)], ticks=200, leaf="qp_converged")


@pytest.mark.parametrize("key", [
    "base_box.c1.state.sim.u", "base_box.c1.state.warm_z",
    "base_box.c1.metrics.com_err"])
def test_a_float32_twin_reaches_past_the_float64_gate(key):
    """Where a rounding decides a branch (base_box's lane 0 in its second
    cycle, which phase 24 holds: its float64 twins stay within 1e-12),
    JAX's own float32 run moved by one ulp lies beyond 5 |JAX f32 - JAX
    f64| + 1e-4 (1 + |f64|): the gate of a float32 route other than JAX's
    rounding needs the twins."""
    with np.load(DATA / "option_golden.npz") as f:
        g = {k: f[k][0].astype(np.float64) for k in f.files
             if k.endswith(key) and k.split(".")[0] in
             ("f64", "f32") + chip_smoke.F32_TWINS}
    ref32, ref64 = g[f"f32.{key}"], g[f"f64.{key}"]
    gate = (5 * np.abs(ref32 - ref64).max()
            + 1e-4 * (1 + np.abs(ref64).max()))
    far = max(np.abs(g[f"{t}.{key}"] - ref32).max()
              for t in chip_smoke.F32_TWINS)
    assert far > gate
