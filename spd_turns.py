#!/usr/bin/env python3
"""The SPD factor and substitution kernels of this checkout and of another
tree, on one card, in turns.

    python3 spd_turns.py --other DIR    # DIR: another tree, e.g. a commit
                                        # unpacked by git archive under
                                        # _checkout/

Builds apf_quadruped_tpu_torch/csrc/spd_chol.cu of this checkout and of DIR
(the C interface is the same in both) and runs ops.cuda_chol's wrappers on
either library:
  1. at the closed loop's shapes (the factor and the substitution with
     k = 1 and 30 at n = 30, B = 64 and 1024; n = 18, B = 64), and
     chol_solve at the use_pallas scan's n = 12 (k = 13, the gains, and
     k = 1, the feed-forward; B = 256, the smoke run's path, and 2048):
     both trees within 1e-5 (relative to the largest entry) of ops.chol's
     plain versions, then the device time of a call in turns
     (chip_smoke.turns: DIR, this, this, DIR, three rounds;
     chip_smoke.window; the median of six windows a tree).  The factor
     and substitution at n = 30, B = 64 are the control of a chol_solve
     change: the factor chain is shared;
  2. the closed loop's tick (chip_smoke.tick_profile: a 20-tick cycle of
     sweep.cli_config() at B = 64) with either library in turns (DIR, this,
     this, DIR): device time a tick, the SPD kernels' part, and the kernels
     recorded against those launched.
Prints the card's name and power limit, and its SM clock and power draw
over the windows, and ptxas's registers, stack and spills for every
kernel of both libraries.  Needs one CUDA card and nvcc; imports no JAX.
"""

import argparse
from pathlib import Path

import numpy as np
import torch

from apf_quadruped_tpu_torch import _kernels
from apf_quadruped_tpu_torch.ops import chol, cuda_chol
from apf_quadruped_tpu_torch.runtime import sweep
from chip_smoke import (check, median, print_ptxas, smi, span, tick_profile,
                        turns, turns_line)

SRC = Path("apf_quadruped_tpu_torch/csrc/spd_chol.cu")


def on(lib, fn):
    """fn, run with the port's SPD wrappers launching from `lib`."""
    def call():
        saved = _kernels.spd_chol
        _kernels.spd_chol = lambda: lib
        try:
            return fn()
        finally:
            _kernels.spd_chol = saved
    return call


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--other", type=Path, required=True)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise RuntimeError("spd_turns.py needs a CUDA card")
    card = smi("name,power.limit")
    other = args.other.name
    libs = {other: _kernels.spd_chol(args.other.resolve() / SRC,
                                     "spd_chol_other"),
            "this": _kernels.spd_chol()}
    print_ptxas(_kernels, "spd_chol_other")
    print_ptxas(_kernels, "spd_chol")
    dev, f32 = torch.device("cuda"), torch.float32
    rng = np.random.default_rng(0)

    def rel(a, b):
        return float((a - b).abs().max() / b.abs().max())

    def clocks(t):
        clock, draw, _ = zip(*(c.split(",") for c in t["clocks"]))
        return f"SM clock {span(clock)} MHz, power draw {span(draw)} W"

    def spd(B, n):
        A = rng.normal(size=(B, n, n))
        return torch.as_tensor(A @ A.transpose(0, 2, 1) + n * np.eye(n),
                               dtype=f32, device=dev)

    def cases():
        """(what, kernel call, plain outputs) at each shape."""
        for n, B in ((30, 64), (30, 1024), (18, 64)):
            H = spd(B, n)
            # row-major, as the kernels read them (cholesky_ex may return
            # its factor column-major; the wrapper would copy it every call)
            Lp, dp = (t.contiguous() for t in chol.plain_factor(H))
            yield (f"factor B={B} n={n}", lambda H=H: cuda_chol.chol_factor(H),
                   (Lp, dp))
            for k in ((1, 30) if n == 30 else (1,)):
                r = torch.as_tensor(rng.normal(size=(B, n, k)), dtype=f32,
                                    device=dev)
                yield (f"sub k={k} B={B} n={n}",
                       lambda r=r, Lp=Lp, dp=dp: cuda_chol.chol_sub(Lp, dp, r),
                       (chol.plain_solve(Lp, dp, r),))
        for B in (256, 2048):
            M = spd(B, 12)
            for k in (13, 1):
                r = torch.as_tensor(rng.normal(size=(B, 12, k)), dtype=f32,
                                    device=dev)
                yield (f"chol_solve k={k} B={B} n=12",
                       lambda M=M, r=r: cuda_chol.chol_solve(M, r),
                       (chol.plain_chol_solve(M, r),))

    for what, fn, plain in cases():
        fns = {tree: on(lib, fn) for tree, lib in libs.items()}
        for tree, call in fns.items():
            out = call()
            out = out if isinstance(out, tuple) else (out,)
            err = max(rel(a, b) for a, b in zip(out, plain))
            check(err <= 1e-5, f"{tree} {what} within 1e-5 of the plain "
                  f"version ({err:.2e})")
        t = turns(fns)
        ratio = (median([w.ms for w in t[other]])
                 / median([w.ms for w in t["this"]]))
        print(f"[turns] {card}: {what}: device time a call, median of 6 "
              f"windows in turns: {turns_line(other, t[other])}, "
              f"{turns_line('this tree', t['this'])}; {ratio:.3f}x; "
              f"{clocks(t)}", flush=True)

    cfg = sweep.cli_config()
    scn = sweep.random_scenarios(cfg, 64, seed=0, device=dev)
    ticks = {other: [], "this": []}
    for tree in (other, "this", "this", other):
        ticks[tree].append(on(libs[tree],
                              lambda: tick_profile(cfg, scn, 20))())
    for tree, ps in ticks.items():
        print(f"[turns] {card}: tick B=64 with {tree}'s spd_chol, two "
              f"20-tick cycles under the profiler: device busy "
              f"{[round(p['dev_us'] / 20e3, 4) for p in ps]} ms a tick, the "
              f"SPD kernels {[round(p['spd_us'] / 20e3, 4) for p in ps]} ms "
              f"({[round(100 * p['spd_us'] / p['dev_us'], 2) for p in ps]}% "
              f"of it), idle "
              f"{[round(100 * (1 - p['dev_us'] / 1e6 / p['wall_s']), 2) for p in ps]}"
              f"%; kernels recorded of those launched "
              f"{[(p['recorded'], sum(p['calls'].values())) for p in ps]}; "
              f"{smi('clocks.sm,power.draw')} after", flush=True)


if __name__ == "__main__":
    main()
