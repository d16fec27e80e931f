"""The port's command line, on the CPU (`--device cpu`).

The commands run at tests/test_sweep.py's small plumbing timing (0.1 s
trot cycle, H=4, one physics substep, 16^2 terrain, 5 iterations),
layered over the command's own configuration, so the robot, the gait and
the tolerances still come from the flags; tests/test_torch_zoo.py and
tests/test_torch_loop.py hold the full configurations to the JAX package.
The configuration of every flag combination equals the JAX CLI's.
"""

import dataclasses
import json
import re
from argparse import Namespace

import numpy as np
import pytest
import torch

from apf_quadruped_tpu.__main__ import _cfg as jax_cli_cfg
from apf_quadruped_tpu_torch import __main__ as cli
from apf_quadruped_tpu_torch.runtime import loop, sweep, viz

torch.set_num_threads(1)

_real_cfg = cli._cfg


def _small(args):
    cfg = _real_cfg(args)
    return cfg.replace(
        gait=dataclasses.replace(cfg.gait, trot_cycle=0.1),
        mpc=dataclasses.replace(cfg.mpc, horizon=4),
        sim=dataclasses.replace(cfg.sim, substeps=1, terrain_res=16),
        solver=dataclasses.replace(cfg.solver, iters=5))


@pytest.fixture
def small(monkeypatch):
    """The commands at the small timing; records each config made."""
    made = []

    def cfg(args):
        made.append(_small(args))
        return made[-1]

    monkeypatch.setattr(cli, "_cfg", cfg)
    return made


@pytest.mark.parametrize("robot", ["dogbot", "anymal", "hyq"])
@pytest.mark.parametrize("gait", ["trot", "crawl", "adaptive", "pace"])
def test_cfg_equals_the_jax_cli(robot, gait):
    args = Namespace(iters=7, robot=robot, gait=gait, sqp=2)
    assert dataclasses.asdict(cli._cfg(args)) == \
        dataclasses.asdict(jax_cli_cfg(args))


def test_cfg_of_dogbot_trot_is_the_sweep_config():
    args = Namespace(iters=15, robot="dogbot", gait="trot", sqp=1)
    assert cli._cfg(args) == sweep.cli_config()
    # the sweep command's parser has no --gait / --sqp
    assert cli._cfg(Namespace(iters=15)) == sweep.cli_config()


RUN_LINE = re.compile(r"cycle (\d+): com=\(([+-]\d\.\d{3}), ([+-]\d\.\d{3}), "
                      r"(\d\.\d{3})\) rob=(\d\.\d{3}) crawl=(\d) "
                      r"qp=(\d\.\d\d) slip=(\d\.\d\d) track=(\d\.\d{3})$")


@pytest.mark.parametrize("flags", [["--case", "2"], ["--world", "block"]])
def test_run_prints_the_jax_lines(small, capsys, monkeypatch, flags):
    """The JAX command's lines, from the run's own metrics."""
    runs = []
    real = cli.run_closed_loop

    def recording(*a, **kw):
        runs.append(real(*a, **kw))
        return runs[-1]

    monkeypatch.setattr(cli, "run_closed_loop", recording)
    cli.main(["run", "--device", "cpu", "--cycles", "2"] + flags)
    st, m, terr, tgt = runs[0]
    assert (terr.h_map is not None) == (flags[0] == "--world")
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 3
    for i, line in enumerate(lines[:2]):
        got = RUN_LINE.match(line)
        assert got, line
        com = m.com[0, i]
        assert got.group(1) == str(i)
        assert got.groups()[1:4] == (f"{com[0]:+.3f}", f"{com[1]:+.3f}",
                                     f"{com[2]:.3f}")
        assert got.group(9) == f"{float(m.track_err[0, i]):.3f}"
    dist = float(torch.linalg.vector_norm(m.com[0, -1, :2] - tgt[0]))
    assert lines[2] == (f"final distance to target: {dist:.3f} m; upright "
                        f"R22={float(st.sim.R_wb[0, 2, 2]):.4f}")


def test_run_plot_writes_both_pngs(small, capsys, tmp_path):
    pytest.importorskip("matplotlib")
    path = str(tmp_path / "run.png")
    cli.main(["run", "--device", "cpu", "--cycles", "1", "--plot", path,
              "--robot", "anymal"])
    assert small[0].robot.mass == 29.5
    out = capsys.readouterr().out
    metrics_png = path.replace(".png", "_metrics.png")
    assert f"wrote {path} and {metrics_png}" in out
    assert (tmp_path / "run.png").stat().st_size > 10_000
    assert (tmp_path / "run_metrics.png").stat().st_size > 10_000


SWEEP = ["sweep", "--device", "cpu", "--batch", "2", "--cycles", "2"]


def _summary(out):
    lines = [ln for ln in out.splitlines() if ln.startswith("scenarios=")]
    assert len(lines) == 1, out
    return lines[0]


def test_sweep_checkpoint_resumes_to_the_same_line(small, capsys, tmp_path,
                                                   monkeypatch):
    cli.main(SWEEP + ["--checkpoint", str(tmp_path / "straight")])
    straight = _summary(capsys.readouterr().out)
    assert straight.startswith("scenarios=2 cycles=2 device=cpu goal_dist")

    real = sweep.run_resumable
    monkeypatch.setattr(sweep, "run_resumable", lambda *a, **kw: real(
        *a, **kw, chunk=1, _crash_after=1))
    killed = str(tmp_path / "killed")
    with pytest.raises(RuntimeError, match="simulated preemption after 1"):
        cli.main(SWEEP + ["--checkpoint", killed])
    monkeypatch.setattr(sweep, "run_resumable", real)
    capsys.readouterr()
    cli.main(SWEEP + ["--checkpoint", killed])
    assert _summary(capsys.readouterr().out) == straight


def test_sweep_robot_and_sharded(small, capsys):
    cli.main(SWEEP[:-1] + ["1", "--robot", "anymal"])
    assert small[-1].robot.mass == 29.5
    assert "scenarios=2 cycles=1 device=cpu" in capsys.readouterr().out
    cli.main(SWEEP + ["--sharded"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert set(json.loads(lines[0])) == {
        "goal_dist", "fell", "qp_converged", "slip_frac"}
    assert lines[1].startswith("scenarios=2 cycles=2 device=cpu")
    # the sharded summary is the plain sweep's
    cli.main(SWEEP)
    assert capsys.readouterr().out.strip() == lines[1]


def test_sweep_on_height_worlds(small, capsys):
    """`sweep --worlds` deals the height worlds over the lanes and prints
    the share of loaded foot-ticks on them; an unknown world is refused."""
    seen = []
    real = sweep.random_scenarios
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(sweep, "random_scenarios",
                   lambda *a, **kw: seen.append(real(*a, **kw)) or seen[-1])
        cli.main(SWEEP + ["--worlds", "slope,stairs"])
    line = _summary(capsys.readouterr().out)
    assert line.startswith("scenarios=2 cycles=2 device=cpu")
    assert " ground_feet=" in line
    scn, = seen
    assert scn.h_map.shape[0] == 2
    assert bool((scn.spawn_xy[:, 1] >= sweep.WORLD_SPAWN_Y[0]).all())
    cli.main(SWEEP)
    assert "ground_feet" not in capsys.readouterr().out
    with pytest.raises(SystemExit):
        cli.main(SWEEP + ["--worlds", "slope,moon"])


def test_bench_rate_at_a_small_batch():
    rec = cli.bench_rate(B=4, device="cpu", bursts=3, reps=2)
    assert rec["metric"] == "batched_mpc_solves_per_s_h20_b4_conv1.00"
    assert rec["unit"] == "solves/s" and rec["value"] > 0.0


def test_bench_prints_the_device_then_the_json(capsys, monkeypatch):
    real = cli.bench_rate
    monkeypatch.setattr(cli, "bench_rate", lambda device: real(
        B=4, device=device, bursts=1, reps=1))
    cli.main(["bench", "--device", "cpu"])
    first, last = capsys.readouterr().out.strip().splitlines()
    assert first.startswith("cpu")
    rec = json.loads(last)
    assert set(rec) == {"metric", "value", "unit", "device"}
    assert rec["device"] == "cpu"


@pytest.mark.parametrize("argv", [["run"], ["bench"],
                                  ["sweep", "--checkpoint", "ckpt"],
                                  ["sweep", "--sharded"],
                                  ["sweep", "--robot", "hyq"]])
def test_commands_need_the_card_or_device_cpu(argv, tmp_path, monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the command would run there")
    monkeypatch.chdir(tmp_path)
    with pytest.raises(RuntimeError, match="--device cpu"):
        cli.main(argv)
    assert not list(tmp_path.iterdir())


def test_run_hands_viz_numpy(small, monkeypatch):
    """`run` passes viz numpy arrays of lane 0 (a card's tensors cannot be
    plotted as they are)."""
    seen = []
    monkeypatch.setattr(viz, "plot_run", lambda path, *a, **kw: seen.append(
        (a, kw)) or path)
    monkeypatch.setattr(viz, "plot_metrics", lambda path, m: seen.append(m)
                        or path)
    cli.main(["run", "--device", "cpu", "--cycles", "1", "--plot", "x.png"])
    (args, kw), m = seen
    assert isinstance(m, loop.CycleMetrics)
    # flat ground: the height-map counter ground_feet is absent (None)
    assert m.ground_feet is None
    for v in list(m[:-1]) + list(args) + [kw["target_xy"]]:
        assert isinstance(v, (np.ndarray, float)), type(v)
