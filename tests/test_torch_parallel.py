"""The scenario mesh and the sharded sweeps of the port, on the CPU.

A mesh is a list of devices whose entries may repeat: ["cpu", "cpu"]
splits the batch in two halves that run one after the other, which is
how these tests exercise the split, the gather and the statistics (the
JAX package's tests use 8 virtual CPU devices).  The loop computes each
lane alone, and its CPU kernels give a lane the same bits in a batch of
2 as in a batch of 4, so a split run equals the one-device run bit for
bit.  The last test runs the sweep in two processes joined by a gloo
process group.
"""

import socket

import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from apf_quadruped_tpu_torch.config import (EngineConfig, GaitConfig,
                                            MpcConfig, SimConfig,
                                            SolverConfig, WbcConfig)
from apf_quadruped_tpu_torch.parallel import distributed, mesh
from apf_quadruped_tpu_torch.runtime import checkpoint, sweep

torch.set_num_threads(1)

# tests/test_sweep.py's tiny config: these tests check plumbing
CFG = EngineConfig(
    gait=GaitConfig(trot_cycle=0.1),
    mpc=MpcConfig(horizon=4, dt=0.025),
    sim=SimConfig(substeps=1, terrain_res=16),
    solver=SolverConfig(iters=5),
    wbc=WbcConfig(slack_weight_trot=1e6),
)
CPU2 = ["cpu", "cpu"]
STATS = ("goal_dist", "qp_converged", "slip_frac")


def scenarios(n, seed):
    return sweep.random_scenarios(CFG, n, seed=seed, use_native=False,
                                  device="cpu")


def leaves(tree):
    out = []
    mesh.tree_map(out.append, tree)
    return out


def assert_equal_trees(a, b):
    la, lb = leaves(a), leaves(b)
    assert len(la) == len(lb) and la
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype and torch.equal(x, y)


def assert_stats_are_means(stats, res):
    for key in STATS:
        torch.testing.assert_close(stats[key], getattr(res, key).mean(),
                                   rtol=1e-6, atol=0)
    torch.testing.assert_close(stats["fell"], res.fell.float().mean(),
                               rtol=1e-6, atol=0)


def test_pad_to_devices():
    assert mesh.pad_to_devices(5, 4) == 8
    assert mesh.pad_to_devices(8, 4) == 8
    assert mesh.pad_to_devices(1, 8) == 8
    assert mesh.pad_to_devices(0, 3) == 0


def test_shard_batch_round_trip():
    m = mesh.scenario_mesh(["cpu"] * 4)
    assert m.devices == (torch.device("cpu"),) * 4 and m.size == 4
    assert (m.rank, m.world) == (0, 1)
    scn = scenarios(8, seed=2)
    shards = mesh.shard_batch(m, scn)
    assert len(shards) == 4
    assert all(s.mu_map.shape == (2, 16, 16) for s in shards)
    assert torch.equal(shards[1].target_xy, scn.target_xy[2:4])
    assert_equal_trees(mesh.gather(m, shards), scn)
    copies = mesh.replicate(m, {"w": torch.ones(3)})
    assert len(copies) == 4 and torch.equal(copies[3]["w"], torch.ones(3))
    with pytest.raises(ValueError, match="does not divide"):
        mesh.shard_batch(m, scenarios(6, seed=2))
    with pytest.raises(ValueError, match="do not split"):
        mesh.scenario_mesh([])


def test_run_sharded_matches_run_batch():
    scn = scenarios(4, seed=3)
    res1 = sweep.run_batch(CFG, scn, 1)
    res2, stats = sweep.run_sharded(CFG, scn, 1, devices=CPU2)
    assert_equal_trees(res2, res1)
    assert res2.final_com.shape == (4, 3)
    assert_stats_are_means(stats, res1)


def test_sharded_map_keeps_per_shard_stats_when_asked():
    m = mesh.scenario_mesh(CPU2)
    fn = mesh.sharded_map(m, lambda x: (x * 2, {"s": x.sum()}),
                          reduce_stats=False)
    out, stats = fn(mesh.shard_batch(m, torch.arange(4.0)))
    assert torch.equal(out, torch.arange(4.0) * 2)
    assert [float(s["s"]) for s in stats] == [1.0, 5.0]


def test_resumable_sharded_survives_kill(tmp_path):
    scn = scenarios(8, seed=11)
    st_ref, m_ref = sweep.run_resumable(CFG, scn, 4, chunk=2, devices=CPU2)
    ck = tmp_path / "shard_ckpt"
    with pytest.raises(RuntimeError, match="simulated preemption"):
        sweep.run_resumable(CFG, scn, 4, chunk=2, ckpt_dir=ck, devices=CPU2,
                            _crash_after=1)
    st2, m2 = sweep.run_resumable(CFG, scn, 4, chunk=2, ckpt_dir=ck,
                                  devices=CPU2)
    assert_equal_trees(st2, st_ref)
    assert_equal_trees(m2, m_ref)
    assert m2.com.shape == (8, 4, 3)
    # the split run equals the one-device run
    st1, m1 = sweep.run_resumable(CFG, scn, 4, chunk=4)
    assert_equal_trees(st1, st_ref)
    assert_equal_trees(m1, m_ref)


def test_ensure_initialized_without_settings_is_a_no_op(monkeypatch):
    for var in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(var, raising=False)
    assert distributed.ensure_initialized() is False
    assert not dist.is_initialized()
    assert distributed.process_info() == {
        "process_index": 0, "process_count": 1, "local_devices": 1,
        "global_devices": 1}


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _gloo_worker(rank, port, out_dir):
    torch.set_num_threads(1)
    assert distributed.ensure_initialized(f"127.0.0.1:{port}", 2, rank)
    try:
        assert distributed.process_info()["process_count"] == 2
        m = mesh.scenario_mesh(CPU2)
        assert (m.rank, m.world, len(m.devices)) == (rank, 2, 1)
        res, stats = sweep.run_sharded(CFG, scenarios(4, seed=3), 1,
                                       devices=CPU2)
        checkpoint.save(f"{out_dir}/rank{rank}.pt",
                        {"res": res, "stats": stats})
    finally:
        dist.destroy_process_group()


def test_two_process_gloo_sweep(tmp_path):
    """Two processes each run one half of a batch of 4; each gets the
    whole batch back by all_gather, equal to the one-process run_batch,
    and the stats averaged by all_reduce are its means."""
    ctx = mp.spawn(_gloo_worker, args=(_free_port(), str(tmp_path)),
                   nprocs=2, join=False)
    try:
        for _ in range(120):                 # the test's own limit: 120 s
            if ctx.join(timeout=1):
                break
        else:
            pytest.fail("the two gloo processes did not finish in 120 s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
            p.join()
    ref = sweep.run_batch(CFG, scenarios(4, seed=3), 1)
    for rank in range(2):
        out = checkpoint.restore(tmp_path / f"rank{rank}.pt",
                                 like={"res": ref, "stats": dict.fromkeys(
                                     ["goal_dist", "fell", "qp_converged",
                                      "slip_frac"], torch.zeros(()))})
        assert_equal_trees(out["res"], ref)
        assert_stats_are_means(out["stats"], ref)
