"""Command line of the port, the JAX package's CLI on torch.

    python -m apf_quadruped_tpu_torch run   --case 2 --target 0,2 --cycles 8
    python -m apf_quadruped_tpu_torch sweep --batch 64 --cycles 6
    python -m apf_quadruped_tpu_torch sweep --worlds slope,stairs --batch 1024
    python -m apf_quadruped_tpu_torch bench

mirrors `python -m apf_quadruped_tpu` with the same flags and lines:
`run` drives one scenario through the closed loop (and with --plot
writes the trajectory and metric plots, which needs matplotlib); `sweep`
walks a batch of random slippery-patch scenarios through it in lockstep
(with --worlds, each lane on one of towr's height worlds, spawned short of
its feature), split over the devices and processes with --sharded,
resumable from a checkpoint directory with --checkpoint; `bench` times
the batched MPC plan (the port's own headline: planner.plan on bench.py's
problem).
Every command runs on the CUDA card (the hand-written kernels), or on the
CPU with `--device cpu` (their plain versions); without a card and
without `--device cpu` it raises.
"""

from __future__ import annotations

import argparse
import json
import subprocess


def _cfg(args):
    """The EngineConfig of a command's flags (runtime.sweep.cli_config)."""
    from .runtime import sweep

    return sweep.cli_config(args.iters, robot=getattr(args, "robot", "dogbot"),
                            gait=getattr(args, "gait", "trot"),
                            sqp=getattr(args, "sqp", 1))


def _device(args):
    from ._device import resolve_device

    return resolve_device(args.device, ask_cpu="--device cpu")


def card_line(device) -> str:
    """`nvidia-smi`'s name and power limit of the card, or the host."""
    if device.type != "cuda":
        return "cpu (no card: the kernels' plain versions)"
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader", f"--id={device.index or 0}"],
        capture_output=True, text=True, check=True).stdout.strip()


def run_closed_loop(cfg, case: int = 0, world: str = "",
                    target: str = "0,1.5", cycles: int = 8, dtype=None,
                    device="cuda"):
    """The `run` command's closed loop: one scenario (B=1) on the case
    world `case` (0 = flat) or the height world `world`, walking to
    `target` ("x,y") for `cycles` replan cycles.  Returns (final
    LoopState, CycleMetrics (1, cycles, ...), Terrain, target (1, 2))."""
    import torch

    from ._device import resolve_device
    from .runtime import loop
    from .sim import disturbance, terrain

    device = resolve_device(device)
    dtype = torch.float32 if dtype is None else dtype
    kw = dict(batch=(1,), dtype=dtype, device=device)
    if world:
        terr = terrain.HEIGHT_WORLDS[world](cfg.sim, **kw)
    elif case > 0:
        terr = terrain.case_world(cfg.sim, case, **kw)
    else:
        terr = terrain.flat(cfg.sim, **kw)
    tgt = torch.tensor([[float(v) for v in target.split(",")]], dtype=dtype,
                       device=device)
    st = loop.init(cfg, 1, dtype=dtype, device=device)
    st2, m = loop.run(cfg, st, terr, tgt,
                      disturbance.empty(dtype, device)[None], n_cycles=cycles)
    return st2, m, terr, tgt


def cmd_run(args):
    import numpy as np

    from . import convert
    from .runtime import loop, viz

    device = _device(args)
    cfg = _cfg(args)
    st2, m, terr, tgt = run_closed_loop(cfg, args.case, args.world,
                                        args.target, args.cycles,
                                        device=device)
    m = loop.CycleMetrics(*(None if v is None else convert.to_numpy(v[0])
                            for v in m))
    com = m.com
    for i in range(len(com)):
        print(f"cycle {i}: com=({com[i, 0]:+.3f}, {com[i, 1]:+.3f}, "
              f"{com[i, 2]:.3f}) rob={float(m.rob_mean[i]):.3f} "
              f"crawl={int(m.fake_crawl[i])} "
              f"qp={float(m.qp_converged[i]):.2f} "
              f"slip={float(m.slip_ticks[i]):.2f} "
              f"track={float(m.track_err[i]):.3f}")
    target = convert.to_numpy(tgt[0])
    goal_err = float(np.linalg.norm(com[-1, :2] - target))
    print(f"final distance to target: {goal_err:.3f} m; "
          f"upright R22={float(st2.sim.R_wb[0, 2, 2]):.4f}")
    if args.plot:
        p1 = viz.plot_run(args.plot, convert.to_numpy(terr.mu_map[0]),
                          cfg.sim.terrain_extent, com, target_xy=target,
                          title=f"case {args.case}, {args.cycles} cycles")
        p2 = viz.plot_metrics(args.plot.replace(".png", "_metrics.png"), m)
        print(f"wrote {p1} and {p2}")


def _summary(args, device, gd, fell, qp_conv, slip, ground):
    import torch

    gd = gd.double().cpu()
    print(f"scenarios={args.batch} cycles={args.cycles} device={device} "
          f"goal_dist mean={float(gd.mean()):.3f} "
          f"p90={float(torch.quantile(gd, 0.9)):.3f} "
          f"fell={int(fell)} qp_conv={float(qp_conv):.2f} "
          f"slip={float(slip):.3f}"
          + ("" if ground is None
             else f" ground_feet={float(ground.mean()):.3f}"))


def cmd_sweep(args):
    import torch

    from .parallel import distributed
    from .runtime import sweep

    device = _device(args)
    cfg = _cfg(args)
    worlds = [w for w in args.worlds.split(",") if w]
    spawn = ((sweep.WORLD_SPAWN_X, sweep.WORLD_SPAWN_Y) if worlds
             else (None, None))
    scn = sweep.random_scenarios(cfg, n=args.batch, seed=args.seed,
                                 device=device, worlds=worlds,
                                 spawn_x=spawn[0], spawn_y=spawn[1])
    if args.checkpoint:
        # resumable chunked driver: a killed sweep restarted with the
        # same --checkpoint picks up at the saved cursor.  As in the JAX
        # command, the distance is the base's, from the final states
        states, m = sweep.run_resumable(cfg, scn, n_cycles=args.cycles,
                                        ckpt_dir=args.checkpoint)
        upright = states.sim.R_wb[:, 2, 2]
        gd = torch.linalg.vector_norm(states.sim.p_base[:, 0:2]
                                      - scn.target_xy, dim=-1)
        _summary(args, device, gd, (upright < 0.7).sum(),
                 m.qp_converged.mean(), m.slip_ticks.mean(),
                 m.ground_feet)
        return
    rank = 0
    if args.sharded:
        distributed.ensure_initialized()
        rank, world = distributed.process_group()
        devices = None if device.type == "cuda" else [device] * world
        res, stats = sweep.run_sharded(cfg, scn, n_cycles=args.cycles,
                                       devices=devices)
        if rank == 0:
            print(json.dumps({k: float(v) for k, v in stats.items()}))
    else:
        res = sweep.run_batch(cfg, scn, n_cycles=args.cycles)
    if rank == 0:
        _summary(args, device, res.goal_dist, res.fell.sum(),
                 res.qp_converged.mean(), res.slip_frac.mean(),
                 res.metrics.ground_feet)


def bench_rate(B: int = 2048, device="cuda", bursts: int = 3,
               reps: int = 50) -> dict:
    """The headline: planner.plan solves/s on bench.py's problem (H=20,
    dt=0.025, SolverConfig(), backend auto, float32) at batch B, the
    median of `bursts` bursts of `reps` plans, each burst fenced by
    torch.cuda.synchronize() on a card.  The metric's name carries the
    cold plan's converged fraction, as bench.py's does."""
    import numpy as np

    from . import planner, problems
    from .config import EngineConfig, MpcConfig, SolverConfig
    from .runtime.profiling import timed

    cfg = EngineConfig(mpc=MpcConfig(horizon=20, dt=0.025),
                       solver=SolverConfig())
    x0, refs = problems.bench_problem(cfg, B, seed=0, device=device)
    out, _ = timed(planner.plan, cfg, x0, refs)
    conv = float(out.sol.converged.float().mean())
    rates = [B / timed(planner.plan, cfg, x0, refs, reps=reps,
                       warmup=False)[1] for _ in range(bursts)]
    return {"metric": f"batched_mpc_solves_per_s_h{cfg.mpc.horizon}"
                      f"_b{B}_conv{conv:.2f}",
            "value": float(np.median(rates)), "unit": "solves/s"}


def cmd_bench(args):
    device = _device(args)
    rec = bench_rate(device=device)
    print(card_line(device))
    print(json.dumps({**rec, "device": str(device)}))


def _worlds(text: str) -> str:
    """--worlds: names of sim/terrain.HEIGHT_WORLDS, comma-separated."""
    from .sim.terrain import HEIGHT_WORLDS

    bad = [w for w in text.split(",") if w and w not in HEIGHT_WORLDS]
    if bad:
        raise argparse.ArgumentTypeError(
            f"unknown height world(s) {bad}; choose from "
            f"{sorted(HEIGHT_WORLDS)}")
    return text


def main(argv=None):
    from .gait import NAMED_MODE_FLAGS
    from .sim.terrain import HEIGHT_WORLDS

    p = argparse.ArgumentParser(prog="apf_quadruped_tpu_torch")
    sub = p.add_subparsers(dest="cmd", required=True)
    device_help = ("torch device of the run (default cuda; cpu runs the "
                   "kernels' plain versions)")

    pr = sub.add_parser("run", help="single closed-loop scenario")
    pr.add_argument("--case", type=int, default=0,
                    help="case world 1-4, 5 = nav_case1a (0 = flat)")
    pr.add_argument("--world", type=str, default="",
                    choices=("",) + tuple(HEIGHT_WORLDS),
                    help="height-map world (overrides --case)")
    pr.add_argument("--target", type=str, default="0,1.5")
    pr.add_argument("--cycles", type=int, default=8)
    pr.add_argument("--iters", type=int, default=15)
    pr.add_argument("--plot", type=str, default="",
                    help="write trajectory PNG here (needs matplotlib)")
    pr.add_argument("--gait",
                    choices=("trot", "crawl", "adaptive")
                    + tuple(NAMED_MODE_FLAGS),
                    default="trot",
                    help="gait mode (adaptive = in-loop robustness "
                         "switch; stride names run that stride fixed)")
    pr.add_argument("--sqp", type=int, default=1,
                    help="SQP outer iterations per MPC solve")
    pr.add_argument("--robot", choices=("dogbot", "anymal", "hyq"),
                    default="dogbot",
                    help="closed-loop robot model (models/zoo.py)")
    pr.add_argument("--device", default="cuda", help=device_help)
    pr.set_defaults(fn=cmd_run)

    ps = sub.add_parser("sweep", help="batched scenario sweep")
    ps.add_argument("--batch", type=int, default=64)
    ps.add_argument("--cycles", type=int, default=6)
    ps.add_argument("--iters", type=int, default=15)
    ps.add_argument("--seed", type=int, default=0)
    ps.add_argument("--robot", choices=("dogbot", "anymal", "hyq"),
                    default="dogbot",
                    help="closed-loop robot model (models/zoo.py)")
    ps.add_argument("--worlds", type=_worlds, default="",
                    help="comma-separated height worlds ("
                         + ", ".join(HEIGHT_WORLDS) + "), dealt evenly "
                         "over the lanes, each lane spawned at x in "
                         "[-0.3, 0.3], y in [0.4, 0.6] m (default: flat "
                         "ground, spawns at the origin)")
    ps.add_argument("--device", default="cuda", help=device_help)
    ps.add_argument("--sharded", action="store_true",
                    help="split over this process's cards (with --device "
                         "cpu, the host), and over the processes of a "
                         "torch.distributed launch")
    ps.add_argument("--checkpoint", default="",
                    help="checkpoint dir: save the sweep cursor/states "
                         "every chunk and resume a killed run "
                         "(runtime.sweep.run_resumable)")
    ps.set_defaults(fn=cmd_sweep)

    pb = sub.add_parser("bench", help="headline benchmark: batched MPC "
                        "plans per second")
    pb.add_argument("--device", default="cuda", help=device_help)
    pb.set_defaults(fn=cmd_bench)

    args = p.parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
