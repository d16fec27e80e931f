#!/usr/bin/env python3
"""The fused Riccati passes, and the use_pallas scan's chol_solve, of this
checkout and of another tree, on one card, in turns.

    python3 fused_turns.py --other DIR    # DIR: another tree, e.g. a commit
                                          # unpacked by git archive under
                                          # _checkout/

Builds apf_quadruped_tpu_torch/csrc/fused_riccati.cu and csrc/spd_chol.cu of
this checkout and of DIR (the C interfaces are the same in both) and runs
the port's wrappers (ops.cuda_riccati, ops.cuda_chol) on either tree's
libraries:
  1. at B = 256 and 2048, H = 20, 13 states, 12 inputs, 24 rows (masks
     0.6): the rollout, factor and vector passes of both within 1e-5
     (relative to the largest entry) of their plain versions; ptxas's
     registers, stack and spills for every kernel of both libraries;
  2. the device time of one call of the rollout (the subject of a rollout
     change), factor and vector passes (its control) in turns (DIR, this,
     this, DIR; three rounds): the median of the profiler windows that
     recorded every launch (chip_smoke.window), and the CUDA-event time in
     the same turns, with each pass's bound (chip_smoke.pass_work) and the
     card's SM clock and power draw;
  3. the fused plan (planner.plan, backend "riccati_fused", bench.py's
     problem, B = 2048, H = 20, cold) with either tree in turns: its
     device time a plan under the profiler, solves/s by the host clock
     (median of 6 bursts of 5 plans), the converged share and the lanes
     whose iters differ from the plain plan (backend "riccati") on the
     same problem;
  4. the scan with SolverConfig(use_pallas=True) (backend "riccati", the
     first 256 scenarios of that problem: every 12 x 12 solve through
     chol_solve) with either tree in turns: its device time a plan, its
     chol_solve launches, the converged share and the lanes whose iters
     agree with the default scan's.
Runs in a process of its own: chip_smoke.py's tick profiles leave later
profiler windows short of events (PERF.md section 7).  Prints the card's
name and power limit beside the numbers.  Needs one CUDA card and nvcc;
imports no JAX.
"""

import argparse
import dataclasses
import time
from pathlib import Path

import numpy as np
import torch

from apf_quadruped_tpu_torch import _kernels, planner, problems
from apf_quadruped_tpu_torch.config import (EngineConfig, MpcConfig,
                                            SolverConfig)
from apf_quadruped_tpu_torch.ops import cuda_chol
from apf_quadruped_tpu_torch.ops import cuda_riccati as cr
from chip_smoke import (bound, check, event_ms, lossless_ms, median,
                        pass_work, print_ptxas, smi, span, turns)

CSRC = Path("apf_quadruped_tpu_torch/csrc")


def on(libs, fn):
    """fn, run with the port's fused-pass and SPD wrappers launching from
    `libs` ({"fused_riccati": ..., "spd_chol": ...})."""
    def call():
        saved = {name: getattr(_kernels, name) for name in libs}
        for name, lib in libs.items():
            setattr(_kernels, name, lambda lib=lib: lib)
        try:
            return fn()
        finally:
            for name, f in saved.items():
                setattr(_kernels, name, f)
    return call


def pass_data(rng, B, dev, H=20, nx=13, nu=12, m=24):
    f32 = dict(dtype=torch.float32, device=dev)
    d = problems.random_stage_qp(rng, B=B, H=H, NX=nx, NU=nu, M=m,
                                 mask_frac=0.6, diag_q=False)
    t = {k: torch.as_tensor(v, device=dev) for k, v in d.items()}
    mask = t["mask"]
    t.update(u=torch.as_tensor(rng.normal(size=(B, H, nu)), **f32),
             zm=mask * torch.as_tensor(rng.uniform(0.1, 2, (B, H, m)), **f32),
             W=mask * torch.as_tensor(rng.uniform(0.1, 10, (B, H, m)), **f32),
             rx=torch.as_tensor(rng.normal(size=(B, H, nu)), **f32),
             vm=mask * torch.as_tensor(rng.normal(size=(B, H, m)), **f32),
             Rreg=t["R"] + 1e-6 * torch.eye(nu, **f32))
    return t


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--other", type=Path, required=True)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise RuntimeError("fused_turns.py needs a CUDA card")
    card = smi("name,power.limit")
    other = args.other.name
    root = args.other.resolve() / CSRC
    libs = {other: {"fused_riccati": _kernels.fused_riccati(
                        root / "fused_riccati.cu", "fused_riccati_other"),
                    "spd_chol": _kernels.spd_chol(root / "spd_chol.cu",
                                                  "spd_chol_other")},
            "this": {"fused_riccati": _kernels.fused_riccati(),
                     "spd_chol": _kernels.spd_chol()}}
    for name in ("fused_riccati_other", "fused_riccati", "spd_chol_other",
                 "spd_chol"):
        print_ptxas(_kernels, name)
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)

    def rel(a, b):
        return float((a - b).abs().max() / b.abs().max())

    for B in (256, 2048):
        d = pass_data(rng, B, dev)
        roll = (d["G"], d["R"], d["Q"], d["A"], d["B"], d["qlin"], d["u"],
                d["zm"], d["x0"])
        fac = (d["G"], d["Rreg"], d["Q"], d["A"], d["B"], d["W"])
        Fp = cr.plain_factor_pass(*fac)
        vec = (d["G"], d["A"], d["B"], *Fp, d["rx"], d["vm"])
        Vp = cr.plain_vector_pass(*vec)
        Rp = cr.plain_rollout(*roll)
        for tree, lib in libs.items():
            X = on(lib, lambda: cr.fused_rollout(*roll))()
            F = on(lib, lambda: cr.fused_factor(*fac))()
            V = on(lib, lambda: cr.fused_vector(*vec))()
            errs = ([rel(a, b) for a, b in zip(X, Rp)]
                    + [rel(a, b) for a, b in zip(F, Fp)]
                    + [rel(a, b) for a, b in zip(V, Vp)])
            check(max(errs) <= 1e-5 and bool((torch.triu(F[0], 1) == 0)
                                              .all()),
                  f"{tree} passes B={B} within 1e-5 of the plain versions "
                  f"({max(errs):.2e})")
            print(f"[check] {tree}: B={B} H=20: rel err rollout x/rx/gu "
                  f"{errs[0]:.2e}/{errs[1]:.2e}/{errs[2]:.2e}, factor "
                  f"L/dinv/K {errs[3]:.2e}/{errs[4]:.2e}/{errs[5]:.2e}, "
                  f"vector du/gdu {errs[6]:.2e}/{errs[7]:.2e} (gate 1e-5)",
                  flush=True)
        for name, fn, reps in (
                ("rollout", lambda: cr.fused_rollout(*roll), 50),
                ("factor", lambda: cr.fused_factor(*fac), 50),
                ("vector", lambda: cr.fused_vector(*vec), 50)):
            fns = {tree: on(lib, fn) for tree, lib in libs.items()}
            t = turns(fns, reps=reps)
            ev = {other: [], "this": []}
            for _ in range(3):
                for tree in (other, "this", "this", other):
                    ev[tree].append(event_ms(fns[tree], reps))
            clock, draw, _ = zip(*(c.split(",") for c in t["clocks"]))
            line = []
            for tree in (other, "this"):
                ms, n = lossless_ms(t[tree])
                line.append(
                    f"{tree} {ms:.5f} ms (median of {n or len(t[tree])} "
                    f"windows{'' if n else ', none lossless'}: "
                    f"{[round(w.ms, 5) for w in t[tree]]}; recorded "
                    f"{min(w.share for w in t[tree]):.2%}-"
                    f"{max(w.share for w in t[tree]):.2%}), CUDA events "
                    f"{median(ev[tree]):.5f} ms "
                    f"{[round(e, 5) for e in ev[tree]]}")
            ratio = lossless_ms(t[other])[0] / lossless_ms(t["this"])[0]
            b = bound(*pass_work(name, B, 20))
            print(f"[turns] {card}: fused {name} B={B} H=20: device time a "
                  f"call in turns: {'; '.join(line)}; {other}/this "
                  f"{ratio:.3f}x; bound {b[0]:.5f} ms ({b[1]}), this at "
                  f"{100 * b[0] / lossless_ms(t['this'])[0]:.2f}% of it; SM "
                  f"clock {span(clock)} MHz, power draw {span(draw)} W",
                  flush=True)

    # the fused plan with either library, against the plain plan
    B, H = 2048, 20
    mpc = dict(horizon=H, dt=0.025)
    cfg = EngineConfig(mpc=MpcConfig(**mpc, backend="riccati_fused"),
                       solver=SolverConfig())
    x0, refs = problems.bench_problem(cfg, B, seed=0, device=dev)
    plain = planner.plan(EngineConfig(mpc=MpcConfig(**mpc,
                                                    backend="riccati"),
                                      solver=SolverConfig()), x0, refs)
    fns = {tree: on(lib, lambda: planner.plan(cfg, x0, refs))
           for tree, lib in libs.items()}
    for tree, fn in fns.items():
        out = fn()
        conv = float(out.sol.converged.float().mean())
        differ = int((out.sol.iters != plain.sol.iters).sum())
        print(f"[plan] {card}: {tree}'s fused plan B={B} H={H} cold: "
              f"converged {conv:.4f} (plain plan "
              f"{float(plain.sol.converged.float().mean()):.4f}), lanes whose "
              f"iters differ from the plain plan {differ} of {B}, mean iters "
              f"{float(out.sol.iters.float().mean()):.3f}", flush=True)
        check(conv >= 0.99, f"{tree}'s fused plan converged")
    t = turns(fns, reps=5)
    rates = {other: [], "this": []}
    for _ in range(3):
        for tree in (other, "this", "this", other):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(5):
                fns[tree]()
            torch.cuda.synchronize()
            rates[tree].append(B * 5 / (time.perf_counter() - t0))
    clock, draw, _ = zip(*(c.split(",") for c in t["clocks"]))
    for tree in (other, "this"):
        ms, n = lossless_ms(t[tree])
        print(f"[plan] {card}: {tree}'s fused plan B={B} H={H} cold, in "
              f"turns: device time {ms:.4f} ms a plan (median of "
              f"{n or len(t[tree])} windows{'' if n else ', none lossless'}: "
              f"{[round(w.ms, 4) for w in t[tree]]}), "
              f"{ms / cfg.solver.iters:.4f} ms an iteration; "
              f"{median(rates[tree]):.1f} solves/s (host clock, median of 6 "
              f"bursts of 5 plans: {[round(r, 1) for r in rates[tree]]}); "
              f"SM clock {span(clock)} MHz, power draw {span(draw)} W",
              flush=True)

    # the scan with use_pallas (every 12 x 12 solve through chol_solve)
    # with either tree, against the default scan
    Bp = 256
    xp, refs_p = x0[:Bp], refs._replace(**{
        k: v[:Bp] for k, v in refs._asdict().items() if v is not None})
    cfg_s = EngineConfig(mpc=MpcConfig(**mpc, backend="riccati"),
                         solver=SolverConfig())
    cfg_p = dataclasses.replace(cfg_s, solver=SolverConfig(use_pallas=True))
    scan = planner.plan(cfg_s, xp, refs_p)
    fns = {tree: on(lib, lambda: planner.plan(cfg_p, xp, refs_p))
           for tree, lib in libs.items()}
    for tree, fn in fns.items():
        n0 = cuda_chol.chol_solve.launches
        out = fn()
        torch.cuda.synchronize()
        launches = cuda_chol.chol_solve.launches - n0
        conv = float(out.sol.converged.float().mean())
        agree = float(((out.sol.iters == scan.sol.iters)
                       & (out.sol.converged == scan.sol.converged))
                      .float().mean())
        print(f"[pallas] {card}: {tree}'s use_pallas plan B={Bp} H={H} "
              f"cold: {launches} chol_solve launches, converged {conv:.4f} "
              f"(default scan {float(scan.sol.converged.float().mean()):.4f})"
              f", converged/iters agree with the default scan on "
              f"{agree:.4f} of lanes", flush=True)
        check(conv >= 0.99 and agree >= 0.995,
              f"{tree}'s use_pallas plan agrees with the default scan")
    t = turns(fns, reps=2)
    clock, draw, _ = zip(*(c.split(",") for c in t["clocks"]))
    for tree in (other, "this"):
        ms, n = lossless_ms(t[tree])
        print(f"[pallas] {card}: {tree}'s use_pallas plan B={Bp} H={H} cold, "
              f"in turns: device time {ms:.4f} ms a plan (median of "
              f"{n or len(t[tree])} windows{'' if n else ', none lossless'}: "
              f"{[round(w.ms, 4) for w in t[tree]]}); SM clock {span(clock)} "
              f"MHz, power draw {span(draw)} W", flush=True)


if __name__ == "__main__":
    main()
