"""Checkpoints and the resumable sweep of the port, on the CPU.

runtime/checkpoint.py keeps every leaf's dtype and replaces a checkpoint
atomically; sweep.run_resumable drives the loop in chunks, writes one
metric shard a chunk and a cursor, and a run killed after a chunk and
resumed equals an uninterrupted one bit for bit (the JAX package's
tests/test_sweep.py, at its small plumbing config).  The last test holds
the resumable driver to the JAX package's float64 loop golden
(tests/data/loop_golden.npz) at tests/test_torch_loop.py's tolerance.
"""

from pathlib import Path

import numpy as np
import pytest
import torch

from apf_quadruped_tpu_torch import convert
from apf_quadruped_tpu_torch.config import (EngineConfig, GaitConfig,
                                            MpcConfig, SimConfig,
                                            SolverConfig, WbcConfig)
from apf_quadruped_tpu_torch.parallel.mesh import tree_map
from apf_quadruped_tpu_torch.runtime import checkpoint, loop, sweep

torch.set_num_threads(1)

# tests/test_sweep.py's tiny config: these tests check plumbing
CFG = EngineConfig(
    gait=GaitConfig(trot_cycle=0.1),
    mpc=MpcConfig(horizon=4, dt=0.025),
    sim=SimConfig(substeps=1, terrain_res=16),
    solver=SolverConfig(iters=5),
    wbc=WbcConfig(slack_weight_trot=1e6),
)
GOLDEN = Path(__file__).resolve().parent / "data" / "loop_golden.npz"


def leaves(tree):
    out = []
    tree_map(out.append, tree)
    return out


def assert_equal_trees(a, b):
    la, lb = leaves(a), leaves(b)
    assert len(la) == len(lb) and la
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype and x.shape == y.shape
        assert torch.equal(x, y)


@pytest.fixture(scope="module")
def scn():
    return sweep.random_scenarios(CFG, 4, seed=7, use_native=False,
                                  device="cpu")


@pytest.fixture(scope="module")
def straight(scn):
    """Six cycles in one step_batch call: the uninterrupted reference."""
    return sweep.step_batch(CFG, scn, sweep.init_batch(CFG, scn), 6)


def test_checkpoint_round_trip_keeps_dtypes(tmp_path):
    st = loop.init(CFG, 3, device="cpu")
    st = st._replace(cycle_idx=torch.tensor([1, 2, 3], dtype=torch.int32),
                     warm_valid=torch.tensor([True, False, True]),
                     sim=st.sim._replace(q=st.sim.q.double() + 0.25))
    tree = {"cycles_done": 4, "states": st}
    path = tmp_path / "ckpt.pt"
    assert not checkpoint.exists(path)
    nbytes = checkpoint.save(path, tree)
    assert checkpoint.exists(path) and nbytes == path.stat().st_size
    back = checkpoint.restore(path, like=tree)
    assert back["cycles_done"] == 4 and isinstance(back["states"],
                                                   loop.LoopState)
    assert_equal_trees(back["states"], st)
    dtypes = {x.dtype for x in leaves(back["states"])}
    assert dtypes == {torch.bool, torch.int32, torch.float32, torch.float64}
    raw = checkpoint.restore(path)
    assert torch.equal(raw["states"]["sim"]["q"], st.sim.q)
    assert not list(tmp_path.glob("*.tmp"))


def test_interrupted_save_keeps_the_previous_checkpoint(tmp_path,
                                                        monkeypatch):
    path = tmp_path / "ckpt.pt"
    first = {"x": torch.arange(5, dtype=torch.int32)}
    checkpoint.save(path, first)

    def half_then_die(obj, f):
        f.write(b"\x00" * 100)
        raise KeyboardInterrupt("killed during the save")

    monkeypatch.setattr(checkpoint.torch, "save", half_then_die)
    with pytest.raises(KeyboardInterrupt):
        checkpoint.save(path, {"x": torch.zeros(7)})
    monkeypatch.undo()
    assert torch.equal(checkpoint.restore(path)["x"], first["x"])
    assert not list(tmp_path.glob("*.tmp"))


def test_chunked_step_matches_run_batch(scn):
    res = sweep.run_batch(CFG, scn, 2)
    states = sweep.init_batch(CFG, scn)
    states, m1 = sweep.step_batch(CFG, scn, states, 1)
    states, m2 = sweep.step_batch(CFG, scn, states, 1)
    assert_equal_trees(sweep._concat_metrics([m1, m2]), res.metrics)
    assert torch.equal(states.sim.R_wb[:, 2, 2], res.upright)


def test_resumable_without_dir_matches_one_call(scn, straight):
    states, m = sweep.run_resumable(CFG, scn, 6, chunk=2)
    assert_equal_trees(states, straight[0])
    assert_equal_trees(m, straight[1])


def test_resumable_sweep_survives_kill(scn, straight, tmp_path):
    ck = tmp_path / "sweep_ckpt"
    with pytest.raises(RuntimeError, match="simulated preemption after 2"):
        sweep.run_resumable(CFG, scn, 6, chunk=2, ckpt_dir=ck,
                            _crash_after=1)
    assert sorted(p.name for p in ck.iterdir()) == [
        "cursor.pt", "metrics-00000000.pt"]
    states, m = sweep.run_resumable(CFG, scn, 6, chunk=2, ckpt_dir=ck)
    assert_equal_trees(states, straight[0])
    assert_equal_trees(m, straight[1])
    assert m.com.shape == (4, 6, 3)
    # a finished checkpoint resumes with nothing left to run
    again = sweep.run_resumable(CFG, scn, 6, chunk=2, ckpt_dir=ck)
    assert_equal_trees(again, (states, m))


def test_resumable_with_nothing_to_do_raises(scn, tmp_path):
    with pytest.raises(ValueError, match="nothing to run"):
        sweep.run_resumable(CFG, scn, 0, ckpt_dir=tmp_path / "empty")
    with pytest.raises(ValueError, match="nothing to run"):
        sweep.run_resumable(CFG, scn, 0)


def test_bytes_a_chunk_do_not_grow(scn, tmp_path, monkeypatch):
    """Each chunk writes its own metric shard and the fixed-size cursor:
    the bytes written a chunk are the same for the first chunk and the
    last (the JAX module re-saves the whole history every chunk)."""
    written = []
    save = checkpoint.save

    def counting_save(path, tree):
        written.append(save(path, tree))
        return written[-1]

    monkeypatch.setattr(checkpoint, "save", counting_save)
    small = sweep.Scenario(*(None if v is None else v[:2] for v in scn))
    sweep.run_resumable(CFG, small, 4, chunk=1, ckpt_dir=tmp_path / "c")
    per_chunk = [a + b for a, b in zip(written[0::2], written[1::2])]
    assert len(per_chunk) == 4
    assert max(per_chunk) == min(per_chunk), per_chunk


def test_resumable_matches_jax_golden():
    with np.load(GOLDEN) as f:
        g = {k: f[k] for k in f.files}
    cfg = sweep.cli_config()
    scn = convert.unflatten(g, "scn", sweep.Scenario)
    states, m = sweep.run_resumable(cfg, scn, 1, chunk=1)
    for prefix, tree in (("f64.state", states), ("f64.metrics", m)):
        keys = [k for k in g if k.startswith(prefix + ".")]
        assert keys
        for key in keys:
            obj = tree
            for part in key.split(".")[2:]:
                obj = getattr(obj, part)
            port = convert.to_numpy(obj)
            if g[key].dtype.kind in "bi":
                np.testing.assert_array_equal(port, g[key], err_msg=key)
            else:
                np.testing.assert_allclose(port, g[key], rtol=0, atol=1e-6,
                                           err_msg=key)
