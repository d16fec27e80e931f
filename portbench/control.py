"""The control's readings, and the program's, for the limits of a cell.

    python3 portbench/control.py --workload <name> --seeds 1,2,3 \
        --seconds 5 [--no-control]

For each seed: the cell's set-up and a short window at its own load, the
program's outputs judged against the reference (the numbers `correct`
compares), then the control judged the same way: the plain reference put
in the program's place, computed one precision below the configuration's
(TF32 on where the configuration states float32 with TF32 off), on the
card, at the cell's size.  One JSON line a seed and side, with each
number and the per-lane distances it was taken from, and, where the
runner reads them, what the timed path's faults would read (a sweep's
tick scan leaving the state unchanged, or half the lanes).  With
--no-control the control is not run.  The benchmark's own runs never run
the control; its limits come from these readings (PERF.md).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent


def _plain(found: dict) -> dict:
    out = {}
    for k, v in found.items():
        if isinstance(v, tuple):
            out[k] = [[float(x) for x in a] for a in v]
        elif isinstance(v, list):
            out[k] = [float(x) for x in v]
        elif isinstance(v, np.ndarray):
            out[k] = v.tolist()
        else:
            out[k] = v
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=5.0)
    p.add_argument("--no-control", action="store_true")
    args = p.parse_args(argv)
    here = str(Path(__file__).resolve().parent)
    sys.path[:] = [p for p in sys.path if os.path.abspath(p or ".") != here]
    sys.path.insert(0, str(ROOT))
    import torch

    from portbench import harness, spec
    cell = spec.cell(args.workload)
    harness.cards_or_exit(cell.workload["chips"])
    for seed in (int(s) for s in args.seeds.split(",")):
        run = harness.Run(cell=cell, seed=seed, seconds=args.seconds,
                          trace=False, device=torch.device("cuda", 0),
                          control=True)
        rnr = harness.runner(run)
        rnr.traffic()
        rnr.warm()
        rnr.window()
        rnr.release()
        torch.cuda.empty_cache()
        t = time.perf_counter()
        found = rnr.check()
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "side": "program", "check_s": time.perf_counter() - t,
                          **_plain(found)}), flush=True)
        if args.no_control:
            continue
        t = time.perf_counter()
        judged = rnr.control()
        torch.cuda.synchronize()
        t_ctrl = time.perf_counter() - t
        found = rnr.judge(*judged)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "side": "control", "control_s": t_ctrl,
                          **_plain(found)}), flush=True)
        del rnr
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
