"""Command line of the port: the batched scenario sweep.

    python -m apf_quadruped_tpu_torch sweep --batch 64 --cycles 6

mirrors `python -m apf_quadruped_tpu sweep`: a batch of random
slippery-patch navigation scenarios walks through the closed loop in
lockstep on the CUDA card (the hand-written kernels), or on the CPU with
`--device cpu` (their plain versions), and the sweep statistics are
printed.  Without a card and without `--device cpu` it raises.  The JAX CLI's other commands (`run`, `bench`) and
the sweep's --sharded and --checkpoint options are not ported yet
(ROADMAP queue 1, item 16).
"""

from __future__ import annotations

import argparse


def cmd_sweep(args):
    import torch

    from ._device import resolve_device
    from .runtime import sweep

    if args.sharded or args.checkpoint:
        raise NotImplementedError(
            "sweep --sharded / --checkpoint are not ported yet (ROADMAP "
            "queue 1, item 16)")
    if args.robot != "dogbot":
        raise NotImplementedError(
            "the zoo robots' closed loop is not ported yet (ROADMAP queue 1, "
            "item 16)")
    device = resolve_device(args.device, ask_cpu="--device cpu")
    cfg = sweep.cli_config(iters=args.iters)
    scn = sweep.random_scenarios(cfg, n=args.batch, seed=args.seed,
                                 device=device)
    res = sweep.run_batch(cfg, scn, n_cycles=args.cycles)
    gd = res.goal_dist.double().cpu()
    print(f"scenarios={args.batch} cycles={args.cycles} device={device} "
          f"goal_dist mean={float(gd.mean()):.3f} "
          f"p90={float(torch.quantile(gd, 0.9)):.3f} "
          f"fell={int(res.fell.sum())} "
          f"qp_conv={float(res.qp_converged.mean()):.2f} "
          f"slip={float(res.slip_frac.mean()):.3f}")


def _not_ported(name):
    def cmd(args):
        raise NotImplementedError(
            f"`{name}` is not ported yet (ROADMAP queue 1, item 16)")
    return cmd


def main(argv=None):
    p = argparse.ArgumentParser(prog="apf_quadruped_tpu_torch")
    sub = p.add_subparsers(dest="cmd", required=True)
    ps = sub.add_parser("sweep", help="batched scenario sweep")
    ps.add_argument("--batch", type=int, default=64)
    ps.add_argument("--cycles", type=int, default=6)
    ps.add_argument("--iters", type=int, default=15)
    ps.add_argument("--seed", type=int, default=0)
    ps.add_argument("--robot", default="dogbot",
                    choices=("dogbot", "anymal", "hyq"))
    ps.add_argument("--device", default="cuda",
                    help="torch device of the run (default cuda; cpu runs "
                    "the kernels' plain versions)")
    ps.add_argument("--sharded", action="store_true")
    ps.add_argument("--checkpoint", default="")
    ps.set_defaults(fn=cmd_sweep)
    for name in ("run", "bench"):
        sub.add_parser(name, help="not ported yet").set_defaults(
            fn=_not_ported(name))
    args = p.parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
