"""runtime/profiling.py of the port: named regions reach torch.profiler,
APF_PROFILE_DIR writes a Chrome trace, `timed` times calls, the solver
statistics of a plan equal the JAX package's on the same problem, and
the cross-process mean is the identity without a process group."""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apf_quadruped_tpu import planner as jplanner
from apf_quadruped_tpu.config import (EngineConfig as JEngineConfig,
                                      MpcConfig as JMpcConfig)
from apf_quadruped_tpu.runtime import profiling as jprofiling
from apf_quadruped_tpu_torch import convert, planner, problems
from apf_quadruped_tpu_torch.config import EngineConfig, MpcConfig
from apf_quadruped_tpu_torch.runtime import profiling

torch.set_num_threads(1)


def test_trace_names_reach_the_profiler():
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with profiling.trace("apf_outer_region"):
            with profiling.trace("apf_inner_region"):
                torch.ones(64).cumsum(0)
    names = {e.key for e in prof.key_averages()}
    assert {"apf_outer_region", "apf_inner_region"} <= names


def test_profile_dir_writes_one_chrome_trace(tmp_path, monkeypatch):
    monkeypatch.setenv("APF_PROFILE_DIR", str(tmp_path))
    with profiling.trace("apf_capture"):
        with profiling.trace("apf_nested"):
            torch.ones(64).cumsum(0)
    files = list(tmp_path.glob("apf_capture-*.json"))
    assert len(files) == 1, list(tmp_path.iterdir())
    events = json.loads(files[0].read_text())["traceEvents"]
    assert {"apf_capture", "apf_nested"} <= {e.get("name") for e in events}
    with profiling.trace("apf_capture"):      # a second capture, a new file
        pass
    assert len(list(tmp_path.glob("apf_capture-*.json"))) == 2


def test_timed_counts_its_calls():
    calls = []

    def fn(x, k=1):
        calls.append(k)
        return x * k

    out, secs = profiling.timed(fn, torch.ones(3), reps=4, k=2)
    assert torch.equal(out, torch.full((3,), 2.0))
    assert len(calls) == 5 and secs >= 0.0
    profiling.timed(fn, torch.ones(3), reps=2, warmup=False)
    assert len(calls) == 7


def test_solver_stats_match_jax():
    cfg = EngineConfig(mpc=MpcConfig(horizon=6, dt=0.025, backend="riccati"))
    x0, refs = problems.bench_problem(cfg, 16, device="cpu")
    jcfg = JEngineConfig(mpc=JMpcConfig(horizon=6, dt=0.025,
                                        backend="riccati"))
    jrefs = jplanner.MpcRefs(**{k: None if v is None else jnp.asarray(v)
                                for k, v in convert.to_numpy(refs)
                                ._asdict().items()})
    jout = jplanner.plan(jcfg, jnp.asarray(x0.numpy()), jrefs)
    stats = profiling.SolverStats.collect(planner.plan(cfg, x0, refs).sol)
    jstats = jprofiling.SolverStats.collect(jout.sol)
    assert stats.conv_frac == jstats.conv_frac
    assert stats.iters_p50 == jstats.iters_p50
    assert stats.iters_p99 == jstats.iters_p99
    np.testing.assert_allclose([stats.gap_max, stats.res_max],
                               [jstats.gap_max, jstats.res_max], rtol=1e-3)
    assert set(stats.as_dict()) == set(jstats.as_dict())


def test_pmean_stats_without_a_group_is_the_identity():
    import torch.distributed as dist

    assert not dist.is_initialized()
    stats = {"goal_dist": torch.tensor(1.5), "fell": 0.25}
    assert profiling.pmean_stats(stats) is stats


@pytest.mark.parametrize("reps", [1, 3])
def test_timed_fences_card_outputs(reps, monkeypatch):
    """On a CUDA output `timed` synchronizes (here a stand-in records the
    call): once after the warm-up, once after the timed calls."""
    synced = []
    monkeypatch.setattr(profiling.torch.cuda, "synchronize",
                        lambda: synced.append(1))
    monkeypatch.setattr(profiling, "_on_cuda", lambda out: True)
    profiling.timed(lambda: torch.ones(1), reps=reps)
    assert len(synced) == 2
