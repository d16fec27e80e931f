#!/usr/bin/env python3
"""The four kernels that SolverConfig.stage_bf16 reaches (the resident IPM
and the fused rollout, factor and vector passes), of this checkout and of
another tree, on one card, in turns.

    python3 bf16_turns.py --other DIR    # DIR: another tree, e.g. a commit
                                         # unpacked by git archive under
                                         # _checkout/

Builds csrc/resident_ipm.cu and csrc/fused_riccati.cu of this checkout and
of DIR (the float32 C interfaces are the same in both) and runs the port's
wrappers (ops.cuda_riccati) on either tree's libraries, at B = 2048, H = 20,
13 states, 12 inputs, 24 rows:
  1. ptxas's registers, stack and spills for every kernel of both trees;
  2. the float32 instances of both trees on the same inputs: the resident
     IPM on bench.py's stage QP, cold, and the three passes (masks 0.6),
     equal bit for bit;
  3. their device time in turns (DIR, this, this, DIR; three rounds): the
     resident kernel by CUDA events, the passes as the median of the
     profiler windows that recorded every launch (chip_smoke.window) and
     by CUDA events;
  4. where DIR has bf16 instances too (a variant of this tree), the bf16
     instances of both the same way: results within 1e-5 (relative to the
     largest entry) and times in turns;
  5. this tree's bf16 instances against its float32 ones in turns (the
     same timers), each with its bound (chip_smoke.pass_work, A and B at
     2 bytes), and the plans through "auto" (the resident kernel) and
     "riccati_fused" with and without the flag: device time a plan under
     the profiler and solves/s by the host clock.
Runs in a process of its own (PERF.md section 7: chip_smoke.py's tick
profiles leave later profiler windows short of events).  Prints the
card's name and power limit beside the numbers.  Needs one CUDA card and
nvcc; imports no JAX.
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
from apf_quadruped_tpu_torch.ops import cuda_riccati as cr
from chip_smoke import (bound, check, event_ms, lossless_ms, median,
                        pass_work, print_ptxas, smi, span, turns)
from fused_turns import on, pass_data

CSRC = Path("apf_quadruped_tpu_torch/csrc")
B, H = 2048, 20


def in_turns(fns, card, label, ev_reps, profile=True):
    """fns' two callables in turns: CUDA events (a, b, b, a; three
    rounds) and, with `profile`, chip_smoke.turns' profiler windows; one
    line; returns {label: ms} (the profiler's where it ran)."""
    a, b = fns
    ev = {a: [], b: []}
    for _ in range(3):
        for k in (a, b, b, a):
            ev[k].append(event_ms(fns[k], ev_reps))
    out = {k: median(v) for k, v in ev.items()}
    parts = [f"{k} {out[k]:.5f} ms by CUDA events "
             f"{[round(e, 5) for e in ev[k]]}" for k in (a, b)]
    clocks = ""
    if profile:
        t = turns(fns, reps=ev_reps)
        clock, draw, _ = zip(*(c.split(",") for c in t["clocks"]))
        for i, k in enumerate((a, b)):
            ms, n = lossless_ms(t[k])
            out[k] = ms
            parts[i] += (f", {ms:.5f} ms under the profiler (median of "
                         f"{n or len(t[k])} windows"
                         f"{'' if n else ', none lossless'}: "
                         f"{[round(w.ms, 5) for w in t[k]]})")
        clocks = f"; SM clock {span(clock)} MHz, power draw {span(draw)} W"
    print(f"[turns] {card}: {label}: {'; '.join(parts)}; {a}/{b} "
          f"{out[a] / out[b]:.3f}x{clocks}", flush=True)
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--other", type=Path, required=True)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise RuntimeError("bf16_turns.py needs a CUDA card")
    card = smi("name,power.limit")
    other = args.other.name
    root = args.other.resolve() / CSRC
    _kernels.resident_ipm_layout()     # this tree's layout, before a swap
    libs = {other: {"resident_ipm": _kernels.resident_ipm(
                        root / "resident_ipm.cu", "resident_ipm_other"),
                    "fused_riccati": _kernels.fused_riccati(
                        root / "fused_riccati.cu", "fused_riccati_other")},
            "this": {"resident_ipm": _kernels.resident_ipm(),
                     "fused_riccati": _kernels.fused_riccati()}}
    for name in ("resident_ipm_other", "resident_ipm", "fused_riccati_other",
                 "fused_riccati"):
        print_ptxas(_kernels, name)
    dev = torch.device("cuda")
    sol32, sol16 = SolverConfig(), SolverConfig(stage_bf16=True)

    # the resident IPM on bench.py's stage QP
    cfg = EngineConfig(mpc=MpcConfig(horizon=H, dt=0.025),
                       solver=sol32)
    x0, refs = problems.bench_problem(cfg, B, seed=0, device=dev)
    qp = planner.stage_qp(cfg, x0, refs)
    res = {tree: on(lib, lambda: cr.solve_stage_qp_resident(qp, sol32))
           for tree, lib in libs.items()}
    a, b = res[other](), res["this"]()
    same = all(torch.equal(getattr(a, f), getattr(b, f))
               for f in ("u", "x", "z", "s", "converged", "iters"))
    print(f"[check] resident IPM float32 B={B} H={H}: {other} and this equal "
          f"bit for bit: {same}", flush=True)
    check(same, "the float32 resident kernel is unchanged in result")
    in_turns(res, card, f"resident IPM float32 B={B} H={H} cold", 10,
             profile=False)

    # the three passes
    d = pass_data(np.random.default_rng(0), B, dev)
    A16, B16 = cr.bf16_knots(d["A"]), cr.bf16_knots(d["B"])

    def calls(A, Bm):
        roll = (d["G"], d["R"], d["Q"], A, Bm, d["qlin"], d["u"], d["zm"],
                d["x0"])
        fac = (d["G"], d["Rreg"], d["Q"], A, Bm, d["W"])
        F = cr.plain_factor_pass(d["G"], d["Rreg"], d["Q"], d["A"], d["B"],
                                 d["W"])
        vec = (d["G"], A, Bm, *F, d["rx"], d["vm"])
        return {"rollout": lambda: cr.fused_rollout(*roll),
                "factor": lambda: cr.fused_factor(*fac),
                "vector": lambda: cr.fused_vector(*vec)}

    k32, k16 = calls(d["A"], d["B"]), calls(A16, B16)
    for name, fn in k32.items():
        fns = {tree: on(lib, fn) for tree, lib in libs.items()}
        same = all(torch.equal(x, y) for x, y in zip(fns[other](),
                                                     fns["this"]()))
        print(f"[check] fused {name} float32 B={B} H={H}: {other} and this "
              f"equal bit for bit: {same}", flush=True)
        check(same, f"the float32 {name} kernel is unchanged in result")
        ms = in_turns(fns, card, f"fused {name} float32 B={B} H={H}", 50)
        b32 = bound(*pass_work(name, B, H))
        print(f"[bound] fused {name} float32: {b32[0]:.5f} ms ({b32[1]}), "
              f"this at {100 * b32[0] / ms['this']:.2f}% of it", flush=True)

    # the bf16 instances of both trees, where the other has them
    if hasattr(libs[other]["fused_riccati"], "fused_rollout_bf16_launch"):
        res16 = {tree: on(lib, lambda: cr.solve_stage_qp_resident(qp, sol16))
                 for tree, lib in libs.items()}
        a, b = res16[other](), res16["this"]()
        agree = float((a.iters == b.iters).float().mean())
        print(f"[check] resident IPM bf16: iters agree on {agree:.4f} of "
              f"lanes, max|du| {float((a.u - b.u).abs().max()):.3g}",
              flush=True)
        check(agree >= 0.995, "the two trees' bf16 resident kernels agree")
        in_turns(res16, card, f"resident IPM bf16 B={B} H={H} cold", 10,
                 profile=False)
        for name, fn in k16.items():
            fns = {tree: on(lib, fn) for tree, lib in libs.items()}
            worst = max(float((x - y).abs().max() / y.abs().max())
                        for x, y in zip(fns[other](), fns["this"]()))
            print(f"[check] fused {name} bf16: {other} and this within "
                  f"{worst:.2e} (gate 1e-5)", flush=True)
            check(worst <= 1e-5, f"the two trees' bf16 {name} kernels agree")
            in_turns(fns, card, f"fused {name} bf16 B={B} H={H}", 50)

    # this tree's bf16 instances against its float32 ones
    ms = in_turns({"bf16": lambda: cr.solve_stage_qp_resident(qp, sol16),
                   "float32": res["this"]}, card,
                  f"resident IPM bf16 / float32 B={B} H={H} cold", 10,
                  profile=False)
    for name in k32:
        ms = in_turns({"bf16": k16[name], "float32": k32[name]}, card,
                      f"fused {name} bf16 / float32 B={B} H={H}", 50)
        b16 = bound(*pass_work(name, B, H, ab_bytes=2))
        print(f"[bound] fused {name} bf16: {b16[0]:.5f} ms ({b16[1]}), at "
              f"{100 * b16[0] / ms['bf16']:.2f}% of it", flush=True)
    for backend in ("auto", "riccati_fused"):
        c = EngineConfig(mpc=MpcConfig(horizon=H, dt=0.025, backend=backend))
        fns = {st: (lambda c=dataclasses.replace(c, solver=s):
                    planner.plan(c, x0, refs))
               for st, s in (("bf16", sol16), ("float32", sol32))}
        ms = in_turns(fns, card, f"plan({backend!r}) bf16 / float32 B={B} "
                      f"H={H} cold, a plan", 5)
        rates = {st: [] for st in fns}
        for _ in range(3):
            for st in ("bf16", "float32", "float32", "bf16"):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(5):
                    fns[st]()
                torch.cuda.synchronize()
                rates[st].append(B * 5 / (time.perf_counter() - t0))
        print(f"[plan] {card}: plan({backend!r}) B={B} H={H} cold: solves/s "
              f"bf16 {median(rates['bf16']):.1f} "
              f"{[round(r, 1) for r in rates['bf16']]}, float32 "
              f"{median(rates['float32']):.1f} "
              f"{[round(r, 1) for r in rates['float32']]} (host clock, "
              f"bursts of 5 plans in turns)", flush=True)


if __name__ == "__main__":
    main()
