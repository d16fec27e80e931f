#!/usr/bin/env python3
"""The closed loop's scenario-ticks/s of this checkout and of another tree,
on one card, in turns.

    python3 loop_turns.py --other DIR [--batch 64 1024] [--rounds 2]
                                          # DIR: another tree, e.g. a commit
                                          # unpacked by git archive under
                                          # _checkout/

Each turn is a process of its own started in one tree (DIR, this, this,
DIR; `--rounds` times for each batch), so that each runs its own tree's
Python as well as its own kernels.  A turn builds that tree's kernels (a
first untimed process a tree builds them once), runs the loop of
sweep.run_batch (sweep.step_batch, one cycle a call) at the CLI's sweep
configuration (sweep.cli_config(), scenarios from
sweep.random_scenarios(seed=0)): one cycle that captures the graphs, then
`--cycles` cycles of 200 ticks, each fenced by torch.cuda.synchronize()
and timed by the host clock.  Prints each turn's scenario-ticks/s, the
median of each side, and the card's name and power limit.  Needs one
CUDA card and nvcc; imports no JAX.
"""

import argparse
import json
import subprocess
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent

# run in the tree's directory: `python -c` puts it first on sys.path
CHILD = """
import json, sys, time
import torch
from apf_quadruped_tpu_torch.runtime import sweep
B, n = int(sys.argv[1]), int(sys.argv[2])
cfg = sweep.cli_config()
scn = sweep.random_scenarios(cfg, B, seed=0, device="cuda")
st = sweep.init_batch(cfg, scn)
st, _ = sweep.step_batch(cfg, scn, st, 1)
walls = []
for _ in range(n):
    torch.cuda.synchronize()
    t = time.perf_counter()
    st, m = sweep.step_batch(cfg, scn, st, 1)
    torch.cuda.synchronize()
    walls.append(time.perf_counter() - t)
print(json.dumps({"walls": walls,
                  "n_ticks": round(cfg.gait.trot_cycle / cfg.sim.dt),
                  "qp_converged": float(m.qp_converged.mean())}))
"""


def turn(tree: Path, B: int, cycles: int) -> dict:
    proc = subprocess.run([sys.executable, "-c", CHILD, str(B), str(cycles)],
                          cwd=tree, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"turn in {tree} at B={B} failed:\n"
                           f"{proc.stderr[-4000:]}")
    return json.loads(proc.stdout.strip().splitlines()[-1])


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--other", required=True, type=Path)
    ap.add_argument("--batch", type=int, nargs="+", default=[64, 1024])
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--cycles", type=int, default=2)
    args = ap.parse_args()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    trees = {"other": args.other.resolve(), "this": ROOT}
    for tree in trees.values():            # builds the tree's kernels
        turn(tree, 8, 1)
    for B in args.batch:
        rates = {"other": [], "this": []}
        for _ in range(args.rounds):
            for label in ("other", "this", "this", "other"):
                out = turn(trees[label], B, args.cycles)
                r = [B * out["n_ticks"] / w for w in out["walls"]]
                rates[label] += r
                print(f"[loop] {card}: B={B} {label} ({trees[label]}): "
                      f"{[round(v, 1) for v in r]} scenario-ticks/s, "
                      f"qp_converged {out['qp_converged']:.4f}", flush=True)
        med = {k: float(np.median(v)) for k, v in rates.items()}
        print(f"[loop] {card}: B={B} scenario-ticks/s over {args.cycles} "
              f"200-tick cycles a turn, {args.rounds} rounds in turns: this "
              f"{med['this']:.1f} ({min(rates['this']):.1f}-"
              f"{max(rates['this']):.1f}), other {med['other']:.1f} "
              f"({min(rates['other']):.1f}-{max(rates['other']):.1f}), "
              f"{med['this'] / med['other']:.4f}x", flush=True)


if __name__ == "__main__":
    main()
