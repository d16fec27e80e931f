#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port (apf_quadruped_tpu_torch) on one GPU.

    python3 chip_smoke.py          # from the repository root, one CUDA card
    python3 chip_smoke.py --phase 21   # the build, then phase 21 alone
    python3 chip_smoke.py --phase 22   # the build, then phase 22 alone
    python3 chip_smoke.py --phase 23   # the build, then phase 23 alone
    python3 chip_smoke.py --phase 24   # the build, then phase 24 alone

Phases; each raises on failure, so any failure exits non-zero:
  1. device: torch/CUDA versions, the card's name and power limit;
  2. build: the resident IPM kernel from csrc/ with nvcc (timed);
  3. kernel vs its plain version (ops.riccati.solve_stage_qp) on the card,
     all 8 warm x state-rows x accel-rows variants, at B=4, at B=130 (over a
     thread-block edge) and at the production shape B=2048, H=20, 13 states,
     12 forces, 24 rows;
  4. planner.plan on the card against a golden written by the JAX package
     (tests/data/plan_golden.npz, B=8, H=20), cold and warm;
  5. the main path: planner.plan on bench.py's problem (B=2048, H=20,
     SolverConfig()) through backend "auto", a warm replan, a
     base_box + base_acc plan; the kernel's launch count must rise;
  6. timing: plan solves/s with the kernel and with the plain version, and
     the kernel's own time against the plain solve, at B=2048, H=20; the
     iterations the cold plan's lanes ran (min, median, max) and the
     kernel's time with every lane running all SolverConfig().iters
     iterations (reltol = abstol = 0), and that time an iteration, which
     the end of the run prints beside the fused passes' (phase 14);
  7. build: the SPD factor/substitution kernels (csrc/spd_chol.cu), built
     with nvcc together with the resident IPM in phase 2 (timed);
  8. the SPD kernels vs their plain versions (ops.chol) on the card at
     n in {18, 30, 64}, k in {1, 30}, B in {1, 64, 1030}, a lane that is
     not positive definite, and solve_qp on WBC-shaped QPs (n=30, p=30,
     m=68, B=1024) through the resident QP kernel (csrc/resident_qp.cu,
     one launch a solve, no SPD kernel) vs the plain route (CPU);
  9. the closed loop, its ticks replayed from a captured CUDA graph of the
     tick (runtime/graph.py): (a) the JAX suite's health case (flat
     ground, target (0, 1), B=8; 2 cycles, cut from its 4 for time, its
     forward progress asked pro rata), (b) the main path, sweep.run_batch
     at the CLI's sweep configuration (B=64, H=20, 128^2 terrain, 2
     cycles), with the kernels' launch counts (a replay adds the launches
     of the captured tick), (c) the loop against the JAX package's
     float32 run (tests/data/loop_golden.npz);
 10. timing: closed-loop scenario-ticks/s, a torch.profiler breakdown of
     the graphed tick and of the eager one beside it (launch calls a
     tick, share of device time in the SPD kernels, device idle share),
     the launch floor, the SPD kernels against their library
     calls (cholesky_ex, cholesky_solve) in turns, the median of six
     profiler windows each (`window`: each kernel's mean over the launches
     recorded times its launches a call, windows that lost more than 5%
     of their launches profiled again; the window total beside it), with
     the library's kernels and the card's SM clock and power beside them
     (factor and substitution k = 1 and 30 at n=30, B in {64, 1024}; n=18,
     B=64), and against their plain versions; the resident QP kernel at
     B in {1, 64, 1024} on the WBC's QPs (problems.wbc_problem): its
     device time (a profiler window, and CUDA events over replays of a
     graph of the call), the op-by-op chain it replaces (_solve_qp_impl on
     the card, a graph of it replayed) and its bound;
 11. build: the fused Riccati passes (csrc/fused_riccati.cu) and the
     rebuilt spd_chol (with chol_solve), built with nvcc together with the
     others in phase 2 (timed, ptxas lines);
 12. the new kernels vs their plain versions on the card: the three fused
     passes (ops/cuda_riccati.plain_*) at B in {4, 130, 2048}, H=20,
     13/12/24, masks all on, mixed and all off, and the rollout at 6/4/8
     and 13/12/32 (B=130); chol_solve at n in {1, 5, 11, 12, 13, 18, 30,
     31, 64}, k in {1, 7, 8, 13, 30}, B in {1, 255, 256, 257, 2049} and a
     non-SPD lane;
 13. the paths: planner.plan with backend "riccati_fused" on bench.py's
     problem (B=2048, H=20), cold and warm, against the plain scan, with
     the three kernels' launch counts, and its base_box reroute to the
     resident kernel; the scan with use_pallas (B=256) through chol_solve;
     the condensed backend (B=256) against the resident plan; the fused
     plan against the JAX golden;
 14. timing: fused plan solves/s beside the resident kernel's, launches a
     fused plan, each fused pass and chol_solve (device time and CUDA
     events) beside its plain version and, for chol_solve, torch.linalg.
     solve, at n=12, k in {13, 1}, B=256 (the use_pallas path's shape, the
     one recorded) and B=2048; the condensed plan.
 15. the resumable sweep: sweep.run_resumable on phase 9(b)'s config and
     scenarios (B=64, 2 cycles), one cycle a chunk, stopped by its test
     hook after the first chunk and resumed from the checkpoint: every
     final LoopState leaf and metric equal to phase 9(b)'s bit for bit;
     the checkpoint's bytes a chunk and the launch counts;
 16. the zoo robots (anymal, hyq) through the `run` command's closed loop
     (flat ground, target (0, 1.5), B=1, one cycle, float32) against the
     JAX package's runs (tests/data/zoo_golden.npz) with phase 9(c)'s gate;
 17. the crawl plan's horizon H=40 (`run --gait crawl`) through the
     resident kernel at B=64 against the plain plan and with phase 3's
     gate on its stage QP, the kernel's time at H=40 (B 64 and 2048), and
     the `bench` command once (its JSON line);
 18. sweep.run_sharded over ["cuda:0"] and ["cuda:0", "cuda:0"] at
     tests/test_sweep.py's small config (B=8, one cycle) against run_batch,
     then inside a world-size-1 NCCL group, where the gather and the
     stats' mean run as NCCL collectives on the card;
 19. SolverConfig.stage_bf16 (A and B at bf16 on the device): the bf16
     instance of the resident IPM against the scan on the rounded stage
     QP at B=2048, H=20, all 8 warm x state-rows x accel-rows variants,
     with phase 3's production gate; the three bf16 fused passes against
     their plain versions (B 130 and 2048, H=20); plans on bench.py's
     problem with the flag through "auto" (the resident kernel) and
     "riccati_fused", cold and warm, against the scan on the rounded
     stage QP, with the launch counts, and their distance from the
     float32 plans; then each bf16 kernel's time in turns with its
     float32 instance (the resident kernel by CUDA events, the passes
     under the profiler and by CUDA events), its bound with A and B at 2
     bytes, and the plans' device time and solves/s with and without the
     flag;
 20. the graphed tick: against the eager tick (loop._scan_ticks_eager),
     every LoopState leaf and CycleMetrics field bit for bit over two
     cycles (cut to 20 ticks) at B=64: trot on flat ground, a height world,
     early touch-down, crawl, pace, adaptive, other scenarios through the
     cached graph, two shards on one card; then at the CLI's sweep
     configuration, B=64 and B=1024: closed-loop scenario-ticks/s and ms a
     tick over 200-tick cycles, the capture's time and memory pool, a
     tick's device time by CUDA events over back-to-back replays and the
     device's idle share, 20-tick cycles graphed and eager in turns, the
     launch calls a tick (phase 10), and the tick's device time by stage
     (references, WBC build, QP, torque map, physics, margin, observer and
     trace), each stage captured alone and replayed;
 21. the graphed plan and cycle head (runtime/graph.call): planner.plan
     against its eager body (planner._plan_eager) bit for bit at B=2048,
     H=20 for every backend and option (auto, with cone_rot, stage_bf16,
     sqp_iters=2, base_box + base_acc; riccati_fused, with cone_rot,
     stage_bf16; the scan; use_pallas; condensed at B=256), cold and warm,
     a second problem through the cached graphs and a NaN lane;
     sweep.run_batch at B=64 with the graphed head and tail against the
     eager ones;
     then, in turns with the eager plan, solves/s at B=2048 ("auto",
     "riccati_fused") and replan latency p50/p99 at B=1 and B=64, each
     graph's capture time and pool, the cycle's head and tail at the
     CLI's sweep configuration (B=64, 1024), and phase 3's
     production-shape parity counts beside them;
 22. the graphed WBC tick (runtime/graph.call): wbc.solve and solve_qp
     against their eager bodies (wbc._solve_eager,
     qpsolve._solve_qp_eager) bit for bit at B in {1, 64, 128, 1024} on
     the WBC latency benchmark's states (problems.wbc_problem, seed 0,
     EngineConfig(), SolverConfig(), float32), a NaN lane, the launch
     counters; the WBC tick latency p50/p99/mean a call, graphed and
     eager in turns (600 graphed and 150 eager calls at B=1, 200 and 50
     at the others), with the host's enqueue time, the graph's device
     time, capture and pool,
     and the B=1 p99 against the reference's 2.5 ms budget (400 Hz); the
     marginal solve in a tick scan (graph.scan of K = 64 and 256 solves
     at B=1, t(K) = a + b K).  Reported, not gated on the budget.
 23. every gait mode of the command line and replan cycles after the
     first against the JAX package's float32 runs
     (tests/data/mode_golden.npz): trot 3 cycles, crawl 1, pace 2 and
     adaptive 2 at the CLI's sweep configuration per mode, on the
     golden's B=2 scenarios, cycle by cycle through sweep.init_batch /
     step_batch (graphed head, tick and tail: the resident IPM at H=20 and
     40, the SPD kernels at n=30 and 18), every leaf of every cycle with
     phase 9(c)'s gate (`golden_gate`), the flags and counts that the JAX
     float64 run itself flips from a start moved by 1e-12 rad (they must
     be TWIN_FLIPS) and a fake_crawl that rounding decides left out and
     named; per case the worst diff / gate, the wall time and the launch
     counts.
 24. the closed loop where phase 23's golden does not reach, against the
     JAX package's float32 runs with phase 23's rules (TWIN_FLIPS_24), a
     share of ticks within one tick, and a lane left out from the cycle
     where the JAX float64 run turns chaotic (CHAOS_Q):
     adaptive switching one lane into crawl while the other trots and a
     lane leaving crawl (tests/data/switch_golden.npz, B=2, 3 cycles), the
     `run` command's closed loop on the slope and the stairs
     (world_golden.npz, B=1, 2 cycles) and the CLI's sweep configuration
     with one opt-in option changed per case (option_golden.npz: qd_limit,
     foothold off, min_exit, rep_field_in_step, base_box, base_acc,
     sqp_iters 2, ref_exact, early touch-down off; B=2, 2 cycles); for
     the left-out lanes, 20-tick cycles graphed against eager bit for bit
     from their heads (every head of the switch), and the switch's crawl
     decisions and warm flags against JAX float32's where no rounding
     decides them (held_decisions); per case the worst diff / gate, the
     wall time, the launch counts and the graphs captured with their
     pools.
The eager sides of phases 10, 20 and 21 swap in the eager bodies:
`eager_ticks` the tick's, `eager_plans` the plan's, the head's and the
tail's, and both those of wbc.solve and solve_qp (`eager_wbc`).
Every kernel's record carries its least possible time on this card
(`bound_ms`: the larger of its bytes over 3.35 TB/s and its float32
operations over 67 TFLOP/s, counted from this run's inputs and, for the
resident IPM, the iterations its lanes ran) and the time of one PyTorch
call computing the same function where there is one (`library_ms`).
The last two lines are the kernels' JSON record and the device JSON line.
Uses no JAX: the card's machine has none.
"""

import dataclasses
import json
import re
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import NamedTuple

import numpy as np

ROOT = Path(__file__).resolve().parent
# H100 SXM peaks (NVIDIA's data sheet, dense, at 700 W)
PEAK_BYTES = 3.35e12          # HBM3, bytes/s
PEAK_FP32 = 67e12             # float32 outside the tensor cores, flop/s


# (tag, iters mismatches, lanes, lanes beyond atol, max |du|,|dx|, atol) of
# every compare_solve call, which phase 21 reports beside its timings
PARITY = []


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"check failed: {msg}")


def bound(nbytes, flops):
    """(least time in ms, "bytes" or "operations") for work that moves
    `nbytes` and does `flops` float32 operations."""
    tb, tf = nbytes / PEAK_BYTES * 1e3, flops / PEAK_FP32 * 1e3
    return (tb, "bytes") if tb >= tf else (tf, "operations")


def knot_flops(nx, nu, m):
    """float32 operations (a multiply-add counts 2) of one knot of each
    Riccati pass, as the kernels and the plain versions compute them:
    (rollout and residuals, factorization, one vector pass)."""
    rollout = 2 * (nx * nx + nx * nu              # x_{k+1} = A x + B u
                   + 2 * nx * nx                  # Q x, A' lam
                   + nu * nu + nx * nu + m * nu   # rx = R u + B' lam + G' z
                   + m * nu)                      # gu = G u
    factor = 2 * (nu * nx * nx + nx ** 3          # B'P, A'P
                  + nu * (nu + 1) // 2 * (m + nx)  # M, lower triangle
                  + nu * nx * nx                  # B'PA
                  + nu ** 3 // 6                  # Cholesky
                  + nx * nu * nu                  # K: two substitutions
                  + nx * nx * (nx + nu))          # P update
    vector = 2 * (m * nu + nx * nu + nu * nu      # g, kff (backward)
                  + nx * nx + nu * nx             # sv
                  + nu * nx + m * nu              # du, gdu (forward)
                  + nx * nx + nx * nu)            # dx
    return rollout, factor, vector


def pass_work(name, B, H, nx=13, nu=12, m=24, ab_bytes=4):
    """(bytes, float32 operations) of one call of the fused pass `name`
    ("rollout", "factor" or "vector"): each input read once, each output
    written once, A_k and B_k at `ab_bytes` bytes an entry (2 with
    stage_bf16), the rest at 4; knot_flops' operations at every knot."""
    f_roll, f_fac, f_vec = knot_flops(nx, nu, m)
    knot_ab = ab_bytes * B * H * (nx * nx + nx * nu)       # A_k, B_k
    return {
        "rollout": (knot_ab + 4 * B * (H * (nx + nu + m + nx + nu + m) + nx),
                    B * H * f_roll),
        "factor": (knot_ab + 4 * B * H * (m + nu * nu + nu + nu * nx),
                   B * H * f_fac),
        "vector": (knot_ab + 4 * B * H * (nu * nu + nu + nu * nx + nu + m
                                          + nu + m),
                   B * H * f_vec)}[name]


def event_ms(fn, reps=50):
    """CUDA-event ms of one call of fn, mean over `reps` back-to-back calls
    after one warm-up call."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


class Launches:
    """What the profiler windows of one callable have shown: each device
    kernel's launches a call, the most any window recorded (its count over
    the calls made, rounded up), and the number of windows."""

    def __init__(self):
        self.per_call, self.windows = {}, 0


class Window(NamedTuple):
    ms: float          # device ms a call: each kernel's mean over the
    #                    launches recorded times its launches a call
    total_ms: float    # the window's recorded device total over the calls
    #                    made (short where the window lost launches)
    launches: dict     # {device kernel: launches a call}
    share: float       # launches recorded / launches made


def window(fn, reps=50, seen=None, min_share=0.95, tries=6):
    """The device time of one call of fn under torch.profiler: a Window of
    `reps` back-to-back calls after one warm-up call.

    A profiler window may record fewer launches than were made (2 of 50
    lost at times, most of them now and then).  `seen` (a Launches, carried from one
    call to the next for the same fn) gives each kernel's launches a call
    once two windows have been profiled; a window that recorded less than
    `min_share` of those launches, or none of one kernel's, is profiled
    again, up to `tries` windows in all, never scaled up.  If none
    qualifies, the best is returned and a line says so; if no window
    recorded anything, the CUDA-event time stands in, saying so."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    seen = Launches() if seen is None else seen
    fn()
    torch.cuda.synchronize()
    got = []
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        rec = {e.key: (e.count, e.self_device_time_total)
               for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and e.count > 0}
        got.append(rec)
        seen.windows += 1
        for key, (count, _) in rec.items():
            seen.per_call[key] = max(seen.per_call.get(key, 0),
                                     -(-count // reps))
        if seen.windows < 2 or not seen.per_call:
            continue
        made = reps * sum(seen.per_call.values())

        def judged(rec):
            whole = all(key in rec for key in seen.per_call)
            return whole, sum(c for c, _ in rec.values()) / made, rec
        whole, share, best = max(map(judged, got), key=lambda w: w[:2])
        if whole and share >= min_share:
            break
    if not seen.per_call:
        print("[time] the profiler recorded no device time in "
              f"{len(got)} windows: the CUDA-event time stands in for the "
              "device time", flush=True)
        ms = event_ms(fn, reps)
        return Window(ms, ms, {}, 0.0)
    if not (whole and share >= min_share):
        print(f"[time] no window of {len(got)} recorded {min_share:.0%} of "
              f"its launches: the best recorded {share:.2%}", flush=True)
    ms = sum(us / count * seen.per_call[key]
             for key, (count, us) in best.items()) / 1e3
    total = sum(us for _, us in best.values()) / 1e3 / reps
    return Window(ms, total, dict(seen.per_call), share)


def call_ms(fn, reps=50):
    """(CUDA-event ms of one call of fn, mean over `reps` back-to-back
    calls; the Window of its device time)."""
    return event_ms(fn, reps), window(fn, reps)


def smi(query):
    """nvidia-smi's reading of `query` for the first card, e.g. 'name,
    power.limit'."""
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]


def turns(fns, rounds=3, reps=50):
    """Profiler windows of two callables in turns (a, b, b, a; `rounds`
    times): {label: [Window, ...], "clocks": [the card's SM clock, power
    draw and power limit after each window]}."""
    (a, _), (b, _) = fns.items()
    seen = {a: Launches(), b: Launches()}
    out = {a: [], b: [], "clocks": []}
    for _ in range(rounds):
        for label in (a, b, b, a):
            out[label].append(window(fns[label], reps, seen[label]))
            out["clocks"].append(smi("clocks.sm,power.draw,power.limit"))
    return out


def median(xs):
    return float(np.median(xs))


def lossless_ms(ws):
    """(median device ms of the Windows that recorded every launch, how
    many did) -- all windows when none did."""
    whole = [w.ms for w in ws if w.share >= 1.0]
    return median(whole or [w.ms for w in ws]), len(whole)


def span(col):
    """'least-most' of a column of nvidia-smi readings ('1980 MHz')."""
    nums = [float(v.split()[0]) for v in col
            if v.split()[0].replace(".", "", 1).isdigit()]
    return f"{min(nums):g}-{max(nums):g}" if nums else "not reported"


def turns_line(label, ws):
    """'label 0.00410 ms [...] (window total 0.00400 ms, 96.00%-100.00% of
    launches recorded)' for the Windows of one side of `turns`."""
    return (f"{label} {median([w.ms for w in ws]):.5f} ms "
            f"{[round(w.ms, 5) for w in ws]} (window total "
            f"{median([w.total_ms for w in ws]):.5f} ms, "
            f"{min(w.share for w in ws):.2%}-{max(w.share for w in ws):.2%} "
            f"of launches recorded)")


LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                "cuLaunchKernelEx", "cudaGraphLaunch")


def tick_graphs():
    """The cached graphs of the ticks (graph.scan), without the cycle
    heads' and plans' (graph.call)."""
    from apf_quadruped_tpu_torch.runtime import graph

    return [e for e in graph.entries() if e.k is not None]


class eager_wbc:
    """Within this block wbc.solve and solve_qp run their eager bodies on
    the card (wbc._solve_eager, qpsolve._solve_qp_eager), the graphs'
    plain versions."""

    def __enter__(self):
        from apf_quadruped_tpu_torch import wbc
        from apf_quadruped_tpu_torch.ops import qpsolve
        self.real_wbc = wbc.solve, qpsolve.solve_qp
        wbc.solve = wbc._solve_eager
        qpsolve.solve_qp = qpsolve._solve_qp_eager

    def __exit__(self, *exc):
        from apf_quadruped_tpu_torch import wbc
        from apf_quadruped_tpu_torch.ops import qpsolve
        wbc.solve, qpsolve.solve_qp = self.real_wbc


class eager_ticks(eager_wbc):
    """Within this block the closed loop runs its ticks eagerly on the card
    (loop._scan_ticks_eager), the graph's plain version, for comparison,
    and each tick's WBC solve eagerly too (eager_wbc)."""

    def __enter__(self):
        from apf_quadruped_tpu_torch.runtime import loop
        super().__enter__()
        self.real = loop._scan_ticks
        loop._scan_ticks = loop._scan_ticks_eager

    def __exit__(self, *exc):
        from apf_quadruped_tpu_torch.runtime import loop
        loop._scan_ticks = self.real
        super().__exit__(*exc)


def tick_profile(cfg, scn, n_ticks, eager=False):
    """One replan cycle of `n_ticks` ticks (sweep.step_batch at `cfg`'s
    configuration, on `scn`; its ticks replayed from the graph, or eager)
    under torch.profiler, after an unprofiled one (which captures the
    graph).  A dict: `calls`, the kernel and graph launch calls the
    profiler saw on the host by API (the port's ctypes libraries' among
    them); `recorded`, the kernels it recorded on the device (copies and
    sets left out); `dev_us` and `spd_us`, the recorded device time of
    every kernel and of the SPD factor and substitution; `wall_s`."""
    import contextlib

    import torch
    from torch.profiler import ProfilerActivity, profile

    from apf_quadruped_tpu_torch.runtime import sweep

    c = cfg.replace(gait=cfg.gait.__class__(
        mode="trot", trot_cycle=n_ticks * cfg.sim.dt))
    st0 = sweep.init_batch(c, scn)
    with eager_ticks() if eager else contextlib.nullcontext():
        sweep.step_batch(c, scn, st0, 1)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t = time.perf_counter()
            sweep.step_batch(c, scn, st0, 1)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t
    ka = prof.key_averages()
    on_dev = [e for e in ka if e.device_type == torch.autograd.DeviceType.CUDA]
    return {"calls": {e.key: e.count for e in ka if e.key in LAUNCH_CALLS},
            "recorded": sum(e.count for e in on_dev if not e.key.startswith(
                ("Memcpy", "Memset"))),
            "dev_us": sum(e.self_device_time_total for e in on_dev),
            "spd_us": sum(e.self_device_time_total for e in on_dev
                          if "spd_factor" in e.key or "spd_sub" in e.key),
            "wall_s": wall}


def print_ptxas(kernels, name):
    """One line a kernel of library `name`: its registers, stack and spills
    as ptxas reported them (names demangled by the toolkit's cu++filt)."""
    filt = Path(kernels.find_nvcc()).parent / "cu++filt"
    for log in sorted(kernels.BUILD_ROOT.glob(f"{name}-*/build.log")):
        fn, spills = "?", ""
        for line in log.read_text().splitlines():
            if "Compiling entry function" in line:
                fn = line.split("'")[1]
                if filt.is_file():
                    full = subprocess.run([str(filt), fn], capture_output=True,
                                          text=True).stdout
                    m = re.search(r"(\w+(?:<[^<>]*>)?)\(", full)
                    fn = m.group(1) if m else fn
            elif "stack frame" in line:
                spills = line.strip()
            elif "registers" in line:
                print(f"[build] {name} ptxas: {fn}: "
                      f"{line.split(':', 1)[1].strip()}; {spills}")

def closed_loop(dev, card, build_spd_s):
    """Phases 7-10; returns phase 9(b)'s run (config, scenarios, final
    states, metrics, seconds) and the SPD kernels' JSON records."""
    import numpy as np
    import torch

    from apf_quadruped_tpu_torch import _kernels, convert
    from apf_quadruped_tpu_torch.config import (EngineConfig, SolverConfig,
                                                WbcConfig)
    from apf_quadruped_tpu_torch.ops import chol, cuda_chol, cuda_riccati
    from apf_quadruped_tpu_torch.ops import qpsolve
    from apf_quadruped_tpu_torch.runtime import loop, native, sweep
    from apf_quadruped_tpu_torch.sim import terrain

    f32 = torch.float32
    rng = np.random.default_rng(0)

    # ---- 7. build --------------------------------------------------------
    print(f"[build] spd_chol built and loaded in {build_spd_s:.1f} s "
          f"(alongside resident_ipm)", flush=True)
    print_ptxas(_kernels, "spd_chol")
    print_ptxas(_kernels, "resident_qp")

    # ---- 8. SPD kernels vs plain on the card ------------------------------
    # gate: L, dinv and X within 1e-5 of the plain version (cuSOLVER
    # potrf + two triangular solves), relative to the largest entry, on
    # well-conditioned SPD input (H = A A' + n I): both are backward
    # stable, so they differ by ~n float32 roundings (~1e-6 at n = 64)
    def spd(B, n):
        A = rng.normal(size=(B, n, n))
        return A @ A.transpose(0, 2, 1) + n * np.eye(n)

    def rel(a, b):
        return float((a - b).abs().max() / b.abs().max())

    err_f = err_s = 0.0
    for n in (18, 30, 64):
        for B in (1, 64, 1030):
            H = torch.as_tensor(spd(B, n), dtype=f32, device=dev)
            L, d = cuda_chol.chol_factor(H)
            Lp, dp = chol.plain_factor(H)
            for k in (1, 30):
                r = torch.as_tensor(rng.normal(size=(B, n, k)), dtype=f32,
                                    device=dev)
                X = cuda_chol.chol_sub(L, d, r)
                Xp = chol.plain_solve(Lp, dp, r)
                torch.cuda.synchronize()
                eL, ed, eX = rel(L, Lp), rel(d, dp), rel(X, Xp)
                err_f = max(err_f, float((L - Lp).abs().max()),
                            float((d - dp).abs().max()))
                err_s = max(err_s, float((X - Xp).abs().max()))
                print(f"[spd] n={n} B={B} k={k}: rel err L {eL:.2e}, dinv "
                      f"{ed:.2e}, X {eX:.2e} (gate 1e-5)", flush=True)
                check(max(eL, ed, eX) <= 1e-5, f"spd kernels n={n} B={B} "
                      f"k={k} within 1e-5 of the plain version")
                check(bool((torch.triu(L, 1) == 0).all()),
                      "L has exact zeros above the diagonal")
    H = torch.as_tensor(spd(5, 30), dtype=f32, device=dev)
    H[2, 3, 3] = -5.0                               # lane 2 is not SPD
    L, d = cuda_chol.chol_factor(H)
    Lp, dp = chol.plain_factor(H)
    X = cuda_chol.chol_sub(L, d, torch.ones(5, 30, 1, device=dev))
    ok = [0, 1, 3, 4]
    nan_k = bool(L[2].isnan().all() & d[2].isnan().all()
                 & X[2].isnan().all())
    nan_p = bool(Lp[2].isnan().all() & dp[2].isnan().all())
    others = bool(L[ok].isfinite().all() & X[ok].isfinite().all())
    print(f"[spd] non-SPD lane: kernel L/dinv/X all NaN {nan_k}, plain "
          f"L/dinv all NaN {nan_p}, other lanes finite {others}", flush=True)
    check(nan_k and nan_p, "a non-SPD lane comes back NaN from the kernel "
          "and the plain version")
    check(others, "the other lanes stay finite")

    # solve_qp on WBC-shaped QPs through the resident QP kernel vs the
    # plain route:
    # tests/test_qpsolve.py's generator, n=30, m=68, p=30 with the WBC's
    # masks (18 of 30 equality rows, 12 of 20 pyramid rows), production
    # SolverConfig() in float32.  Gates: converged/iters agree on >= 99.5%
    # of lanes; where they agree, x within 1e-3 (1 + |x|max) on >= 99.5%:
    # a solve that stops at reltol 1e-2 passes float32 rounding of the
    # factorizations on amplified by the KKT conditioning
    Bq, n, m, p = 1024, 30, 68, 30
    Mq = rng.normal(size=(Bq, n, n))
    P = np.einsum("bij,bkj->bik", Mq, Mq) / n + 0.5 * np.eye(n)
    G = rng.normal(size=(Bq, m, n))
    x0 = rng.normal(size=(Bq, n)) * 0.1
    Aq = rng.normal(size=(Bq, p, n))
    data = dict(P=P, q=rng.normal(size=(Bq, n)), G=G,
                h=np.einsum("bmn,bn->bm", G, x0)
                + rng.uniform(0.1, 1.0, (Bq, m)),
                A=Aq, b=np.einsum("bpn,bn->bp", Aq, x0),
                eq_mask=np.concatenate([np.ones((Bq, 18)),
                                        np.zeros((Bq, 12))], axis=1),
                ineq_mask=np.concatenate([
                    (rng.uniform(size=(Bq, 20)) < 0.6).astype(float),
                    np.ones((Bq, 48))], axis=1))
    data = {k: v.astype(np.float32) for k, v in data.items()}
    before = read_launches()
    sol_k = qpsolve.solve_qp(convert.qp_data(data, dev), SolverConfig())
    sol_p = qpsolve.solve_qp(convert.qp_data(data, "cpu"), SolverConfig())
    after = read_launches()
    check(after["resident_qp"] == before["resident_qp"] + 1
          and after["spd_chol_factor"] == before["spd_chol_factor"]
          and after["spd_chol_sub"] == before["spd_chol_sub"],
          "solve_qp on CUDA tensors launched the resident QP kernel once "
          "and no SPD kernel")
    conv_k, conv_p = sol_k.converged.cpu(), sol_p.converged
    agree = (conv_k == conv_p) & (sol_k.iters.cpu() == sol_p.iters)
    dx = (sol_k.x.cpu() - sol_p.x).abs().amax(dim=-1)[agree]
    xs = 1.0 + float(sol_p.x.abs().max())
    within = float((dx <= 1e-3 * xs).float().mean())
    print(f"[qp] WBC-shaped solve_qp B={Bq}: converged "
          f"{float(conv_k.float().mean()):.4f} (plain "
          f"{float(conv_p.float().mean()):.4f}), converged/iters agree on "
          f"{float(agree.float().mean()):.4f} of lanes, max|dx| "
          f"{float(dx.max()):.3g} (|x|max {xs - 1:.3g}), within gate on "
          f"{within:.4f}", flush=True)
    check(float(agree.float().mean()) >= 0.995, "solve_qp kernel route "
          "agrees with the plain route on converged/iters")
    check(within >= 0.995, "solve_qp kernel route x within tolerance")

    # ---- 9. the closed loop -----------------------------------------------
    def finite(tree):
        return all(bool(torch.isfinite(v.float()).all()) for v in tree
                   if isinstance(v, torch.Tensor))

    # (a) tests/test_loop.py's health case: the production config
    cfg_h = EngineConfig(solver=SolverConfig(),
                         wbc=WbcConfig(slack_weight_trot=1e6))
    # depth cut from the JAX test's 4 cycles to 2 for time; its forward
    # progress, 0.15 m in 4 cycles, is asked pro rata
    Bh, cycles_h = 8, 2
    y_min = 0.15 * cycles_h / 4
    t0 = time.perf_counter()
    st, m = loop.run(cfg_h, loop.init(cfg_h, Bh, device=dev),
                     terrain.flat(cfg_h.sim, batch=(Bh,), device=dev),
                     torch.tensor([[0.0, 1.0]] * Bh, device=dev),
                     torch.zeros((Bh, 1, 8), device=dev), cycles_h)
    torch.cuda.synchronize()
    com_y = m.com[:, -1, 1]
    print(f"[loop] health case B={Bh}, {cycles_h} cycles in "
          f"{time.perf_counter() - t0:.1f} s: CoM y min "
          f"{float(com_y.min()):.4f} (> {y_min:g}), R22 min "
          f"{float(st.sim.R_wb[:, 2, 2].min()):.5f} (> 0.98), MPC converged "
          f"{bool(m.mpc_converged.all())}, qp_converged mean "
          f"{float(m.qp_converged.mean()):.4f} (> 0.9), track_err mean "
          f"{float(m.track_err.mean()):.5f} m (< 0.03), tau max "
          f"{float(m.tau_max.max()):.3f} (<= 60)", flush=True)
    check(finite(st.sim) and finite(m), "health case finite")
    check(float(com_y.min()) > y_min, "health case walks forward")
    check(float(st.sim.R_wb[:, 2, 2].min()) > 0.98, "health case upright")
    check(bool(m.mpc_converged.all()), "health case MPC converged")
    check(float(m.qp_converged.mean()) > 0.9, "health case WBC converged")
    check(float(m.track_err.mean()) < 0.03, "health case tracking")
    check(float(m.tau_max.max()) <= 60.0 + 1e-4, "health case torque limit")

    # (b) the main path: sweep.run_batch at the CLI's sweep configuration
    cfg = sweep.cli_config()
    Bs, cycles = 64, 2
    scn = sweep.random_scenarios(cfg, Bs, seed=0, device=dev)
    print(f"[loop] scenarios from the "
          f"{'native C++' if native.available() else 'numpy'} generator",
          flush=True)
    ticks = Bs * cycles * int(round(cfg.gait.trot_cycle / cfg.sim.dt))
    zero_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    # sweep.run_batch, its two steps apart: phase 15 holds every leaf of
    # these final LoopStates, which the SweepResult does not carry
    states_b, metrics_b = sweep.step_batch(cfg, scn,
                                           sweep.init_batch(cfg, scn), cycles)
    res = sweep.result(scn, states_b, metrics_b)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches()
    print(f"[loop] run_batch B={Bs}, {cycles} cycles in {wall:.1f} s; "
          f"kernel launches {launches}", flush=True)
    # a tick: one resident QP launch (the WBC solve) and physics' 4
    # mass-matrix factors; no n = 30 SPD launch
    n_ticks = ticks // Bs
    check(launches["resident_qp"] == n_ticks
          and launches["spd_chol_factor"] == 4 * n_ticks,
          f"a tick launched the resident QP kernel once and 4 SPD factors "
          f"({launches} over {n_ticks} ticks)")
    mpc_conv = float(res.metrics.mpc_converged.float().mean())
    print(f"[loop] fell {int(res.fell.sum())}/{Bs}, goal_dist mean "
          f"{float(res.goal_dist.mean()):.4f} m, slip_frac mean "
          f"{float(res.slip_frac.mean()):.4f}, qp_converged mean "
          f"{float(res.qp_converged.mean()):.4f} (> 0.9), MPC converged on "
          f"{mpc_conv:.4f} of (lane, cycle) (>= 0.99), upright min "
          f"{float(res.upright.min()):.4f}", flush=True)
    check(finite(res) and finite(res.metrics), "run_batch outputs finite")
    check(float(res.qp_converged.mean()) > 0.9, "run_batch WBC converged")
    check(mpc_conv >= 0.99, "run_batch MPC converged")
    check(all(v > 0 for v in launches.values()),
          "the main path launched every kernel")

    # (c) against the JAX package's float32 loop (B=4, one cycle), with
    # golden_gate's per-leaf gate
    with np.load(ROOT / "tests" / "data" / "loop_golden.npz") as f:
        g = {k: f[k] for k in f.files}
    scn_g = convert.unflatten(g, "scn", sweep.Scenario, dev)
    scn_g = sweep.Scenario(*(None if v is None else v.to(f32)
                                  for v in scn_g))
    st_g, m_g = sweep.step_batch(cfg, scn_g, sweep.init_batch(cfg, scn_g), 1)
    worst = golden_gate(g, "", {"state": st_g, "metrics": m_g})
    print(f"[loop] vs JAX float32 golden: every leaf within its gate, "
          f"worst {worst[1]} at {worst[0]:.3f} of its gate", flush=True)

    # ---- 10. timing ---------------------------------------------------------
    print(f"[time] {card}: closed loop B={Bs}: {ticks / wall:.1f} "
          f"scenario-ticks/s, {1e3 * wall / (ticks / Bs):.2f} ms per tick "
          f"(run_batch, {cycles} cycles, host clock, the graph's capture "
          f"in the first; phase 20 times the cycles after it)", flush=True)
    # the tick under torch.profiler: two short cycles (10 and 20 ticks, the
    # same tick as the main path's), launches per tick from the difference;
    # the kernels recorded on the device against the launch calls say how
    # far the recorded device time is short.  The graphed tick (the main
    # path's) and the eager one beside it
    profiles = {}
    for label, eager in (("graphed", False), ("eager", True)):
        p10, p20 = (tick_profile(cfg, scn, n, eager) for n in (10, 20))
        made = sum(p20["calls"].values())
        per_tick = (made - sum(p10["calls"].values())) / 10
        d20, w20 = p20["dev_us"], p20["wall_s"]
        if d20 > 0:
            shares = (f"SPD kernels {100 * p20['spd_us'] / d20:.2f}% of "
                      f"device time; device busy {d20 / 1e3:.3f} of "
                      f"{1e3 * w20:.3f} ms, idle "
                      f"{100 * (1 - d20 / 1e6 / w20):.2f}%")
        else:
            shares = "device time not measured (the profiler saw none)"
        print(f"[time] {card}: profiled {label} tick B={Bs}: {per_tick:.1f} "
              f"launch calls a tick ({made} in a 20-tick cycle, by API "
              f"{p20['calls']}; {sum(p10['calls'].values())} in a 10-tick "
              f"one); {shares} (20-tick cycle under the profiler); device "
              f"busy {d20 / 20e3:.3f} ms a tick; the window recorded "
              f"{p20['recorded']} kernels on the device for the {made} "
              f"launch calls", flush=True)
        profiles[label] = dict(per_tick=per_tick, calls=p20["calls"],
                               dev_ms=d20 / 20e3, wall_ms=1e3 * w20 / 20)

    # the kernels against their library calls (cholesky_ex; cholesky_solve
    # on the factor), in turns (kernel, library, library, kernel, three
    # rounds): six profiler windows of 50 back-to-back calls each, the
    # device time a call of each window (each kernel's mean times its
    # launches a call; the window total over the calls beside it), its
    # median, the kernels the library call launched, and the card's SM
    # clock and power sampled after each window.  The plain versions
    # (call_ms) and the CUDA-event time of a call (host-bound at these
    # sizes: the call's cost to a caller) beside them.  The launch floor:
    # one elementwise kernel on 64 floats, timed the same way.  The bounds
    # count the bytes the functions need: the factor reads H's lower
    # triangle and writes L whole and dinv; the substitution reads L's
    # strict lower triangle, dinv and rhs and writes X
    z = torch.zeros(64, device=dev)
    floor, seen = [], Launches()
    for _ in range(5):
        floor.append(window(z.zero_, seen=seen).ms)
    print(f"[time] {card}: launch floor (one elementwise kernel on 64 "
          f"floats): {median(floor):.5f} ms device time a call (median of 5 "
          f"windows {[round(x, 5) for x in floor]})", flush=True)
    src = "apf_quadruped_tpu_torch/csrc/spd_chol.cu"
    times = {}
    for n, B in ((30, 64), (30, 1024), (18, 64)):
        H = torch.as_tensor(spd(B, n), dtype=f32, device=dev)
        F = cuda_chol.chol_factor(H)
        Fp = chol.plain_factor(H)
        cases = [(("factor", B, n, 0), lambda: cuda_chol.chol_factor(H),
                  lambda: chol.plain_factor(H),
                  lambda: torch.linalg.cholesky_ex(H),
                  bound(4 * B * (n * (n + 1) // 2 + n * n + n),
                        B * n ** 3 / 3))]
        for k in ((1, 30) if n == 30 else (1,)):
            r = torch.as_tensor(rng.normal(size=(B, n, k)), dtype=f32,
                                device=dev)
            cases.append((("sub", B, n, k),
                          lambda r=r: cuda_chol.chol_sub(*F, r),
                          lambda r=r: chol.plain_solve(*Fp, r),
                          lambda r=r: torch.cholesky_solve(r, Fp[0]),
                          bound(4 * B * (n * (n - 1) // 2 + n + 2 * n * k),
                                B * 2 * n * n * k)))
        for key, kern, plain, lib, b in cases:
            t = turns({"kernel": kern, "library": lib})
            ms, lms = event_ms(kern), event_ms(lib)
            pms, pw = call_ms(plain)
            kind, k = key[0], key[3]
            times[key] = (median([w.ms for w in t["kernel"]]), pw.ms,
                          median([w.ms for w in t["library"]]), b)
            clock, draw, limit = zip(*(c.split(",") for c in t["clocks"]))
            what = f"spd {kind} B={B} n={n}{f' k={k}' if k else ''}"
            print(f"[time] {card}: {what}: device time a call, median of 6 "
                  f"windows in turns: {turns_line('kernel', t['kernel'])}, "
                  f"{turns_line('library', t['library'])}; plain "
                  f"{pw.ms:.5f} ms; bound {b[0]:.6f} ms ({b[1]}); a call by "
                  f"CUDA events (host-bound): kernel {ms:.4f}, plain "
                  f"{pms:.4f}, library {lms:.4f} ms; SM clock {span(clock)} "
                  f"MHz, power draw {span(draw)} W, power limit "
                  f"{span(limit)} W over the windows", flush=True)
            print(f"[time] {card}: {what}: the library call launched "
                  + ", ".join(f"{c:g} x {name[:72]}" for name, c in
                              t["library"][-1].launches.items()), flush=True)

    fac, sub = times[("factor", 64, 30, 0)], times[("sub", 64, 30, 1)]
    main_path = dict(cfg=cfg, scn=scn, states=states_b, metrics=metrics_b,
                     wall=wall, profiles=profiles)
    qp_row = resident_qp_times(dev, card, launches["resident_qp"] // n_ticks)
    return main_path, [qp_row,
        {"name": "spd_chol_factor", "route": "cuda", "source": src,
         "replaces": "apf_quadruped_tpu/ops/pallas_chol.py:130",
         "launches": launches["spd_chol_factor"], "max_abs_err": err_f,
         "ms": fac[0], "plain_ms": fac[1], "bound_ms": fac[3][0],
         "bound_by": fac[3][1], "library_ms": fac[2]},
        {"name": "spd_chol_sub", "route": "cuda", "source": src,
         "replaces": "apf_quadruped_tpu/ops/pallas_chol.py:158",
         "launches": launches["spd_chol_sub"], "max_abs_err": err_s,
         "ms": sub[0], "plain_ms": sub[1], "bound_ms": sub[3][0],
         "bound_by": sub[3][1], "library_ms": sub[2]}]


def qp_work(B, n=30, p=30, m=68, iters=15, refine=1):
    """(bytes, float32 operations) of one solve of B QPs of the resident QP
    kernel (csrc/resident_qp.cu), every lane running all `iters`
    iterations (there is no early exit).  A multiply-add counts 2; each
    input is read once and each output written once.  A factorization
    pass: the Gram G'WG's lower triangle and W G, H's factor, V = L^-1 A'
    (p forward substitutions), V'V's lower triangle and S_eq's factor; a
    KKT solve: two half substitutions with L and V'u, S_eq's two, V dy;
    each refinement H dx (P, G, W, G'), A'dy, A dx; a Newton step: the
    right-hand side G'(w rz + rc / s), the KKT solve, ds = -rz - G dx and
    dz; the residuals: P x, A'y, G'z, A x, G x and the sums."""
    tri = lambda k: k * (k + 1) // 2                     # noqa: E731
    chol = lambda k: (k ** 3 - k) / 3 + k * (k - 1) / 2 + 2 * k  # noqa
    factor = (2 * tri(n) * m + m * n + chol(n) + p * n * n
              + 2 * tri(p) * n + chol(p))
    once = 2 * n * n + 4 * n * p + 2 * p * p
    kkt = (1 + refine) * once + refine * (2 * (2 * m * n) + m + 2 * n * n
                                          + 2 * (2 * n * p) + n + p)
    newton = 2 * m * n + 3 * m + kkt + 2 * m * n + 4 * m
    resid = 2 * n * n + 4 * n * p + 4 * m * n + 6 * m + 2 * (n + p)
    step = 10 * m + 2 * (n + p)           # step lengths, mu_aff, the update
    flops = ((iters + 1) * factor + iters * (2 * newton + step)
             + (iters + 1) * resid + kkt + 2 * m * n)
    nbytes = 4 * (n * n + n + p * n + 2 * p + m * n + 2 * m   # P .. masks
                  + n + p + 2 * m + 3) + 1                    # x .. res
    return float(B * nbytes), float(B * flops)


def resident_qp_times(dev, card, per_tick):
    """Phase 10's row of the resident QP kernel: at B in {1, 64, 1024} on
    the WBC's QPs (problems.wbc_problem, seed 0, EngineConfig(),
    SolverConfig(), float32), the device time of one solve (a profiler
    window of back-to-back calls, and CUDA events over replays of a graph
    of the call) against the op-by-op chain it replaces (_solve_qp_impl on
    the card, a graph of it replayed: its SPD kernels and glue), and the
    kernel's bound (qp_work)."""
    from apf_quadruped_tpu_torch import _precision, problems, wbc
    from apf_quadruped_tpu_torch.config import EngineConfig
    from apf_quadruped_tpu_torch.ops import qpsolve

    cfg = EngineConfig()
    rows = {}
    for B in (1, 64, 1024):
        st, ref = problems.wbc_problem(cfg, B, seed=0, device=dev)
        with _precision.highest_precision():
            qp, _ = wbc._build_qp(cfg, st, ref)

        def kern():
            return qpsolve._solve_qp_eager(qp, cfg.solver)

        def chain():
            with _precision.highest_precision():
                return qpsolve._solve_qp_impl(qp, cfg.solver)

        w = window(kern)
        k_ms = replay_ms(kern)
        c_ms = replay_ms(chain, reps=10)
        b = bound(*qp_work(B, iters=cfg.solver.iters,
                           refine=cfg.solver.refine_steps))
        rows[B] = (w.ms, k_ms, c_ms, b)
        print(f"[time] {card}: resident QP B={B}: device time a solve "
              f"{w.ms:.5f} ms (profiler window, {w.share:.2%} of launches "
              f"recorded; {', '.join(w.launches)}), {k_ms:.5f} ms (CUDA "
              f"events, graph replays); the chain it replaces {c_ms:.4f} ms "
              f"(graph replays), {c_ms / k_ms:.1f}x; bound {b[0]:.6f} ms "
              f"({b[1]}), {100 * b[0] / k_ms:.2f}% of it; {per_tick} "
              f"launch a tick or WBC solve", flush=True)
    k = rows[1024]
    return {"name": "resident_qp", "route": "cuda",
            "source": "apf_quadruped_tpu_torch/csrc/resident_qp.cu",
            "replaces": "apf_quadruped_tpu_torch/ops/qpsolve.py:"
                        "_solve_qp_impl (apf_quadruped_tpu/ops/qpsolve.py)",
            "launches": per_tick, "max_abs_err": None,
            "ms": {B: r[1] for B, r in rows.items()},
            "plain_ms": {B: r[2] for B, r in rows.items()},
            "bound_ms": k[3][0], "bound_by": k[3][1], "library_ms": None}


def fused_pass_data(rng, dev, B, mask_frac, H=20, nx=13, nu=12, m=24):
    """Inputs of the three fused passes on the card, from `rng`: a random
    stage QP's G, R, Q, A, B, qlin, mask, x0, and u, zm, W, rx, vm (the
    rows masked), Rreg = R + 1e-6 I."""
    import torch

    from apf_quadruped_tpu_torch import problems

    f32 = torch.float32
    d = problems.random_stage_qp(rng, B=B, H=H, NX=nx, NU=nu, M=m,
                                 mask_frac=mask_frac, diag_q=False)
    t = {k: torch.as_tensor(v, device=dev) for k, v in d.items()}

    def rnd(*shape, lo=None, hi=None):
        v = (rng.uniform(lo, hi, shape) if lo is not None
             else rng.normal(size=shape))
        return torch.as_tensor(v, dtype=f32, device=dev)
    mask = t["mask"]
    t.update(u=rnd(B, H, nu), zm=mask * rnd(B, H, m, lo=0.1, hi=2.0),
             W=mask * rnd(B, H, m, lo=0.1, hi=10.0), rx=rnd(B, H, nu),
             vm=mask * rnd(B, H, m),
             Rreg=t["R"] + 1e-6 * torch.eye(nu, dtype=f32, device=dev))
    return t


def fused_slice(dev, card, build_s, golden, compare_solve, x0, refs, x1,
                refs1, plain_cold, rate_resident):
    """Phases 11-14; returns the four new kernels' JSON records."""
    import dataclasses

    import numpy as np
    import torch

    from apf_quadruped_tpu_torch import _kernels, planner, problems
    from apf_quadruped_tpu_torch.config import (EngineConfig, MpcConfig,
                                                SolverConfig)
    from apf_quadruped_tpu_torch.ops import chol, cuda_chol
    from apf_quadruped_tpu_torch.ops import cuda_riccati as cr
    from apf_quadruped_tpu_torch.ops import riccati

    f32 = torch.float32
    rng = np.random.default_rng(3)
    passes = (cr.fused_rollout, cr.fused_factor, cr.fused_vector)

    def counts():
        return tuple(f.launches for f in passes)

    # ---- 11. build ----------------------------------------------------------
    print(f"[build] fused_riccati built in {build_s['fused_riccati']:.1f} s, "
          f"spd_chol (with chol_solve) in {build_s['spd_chol']:.1f} s, in "
          f"parallel with resident_ipm (phase 2)", flush=True)
    print_ptxas(_kernels, "fused_riccati")
    print_ptxas(_kernels, "spd_chol")

    # ---- 12. the new kernels vs their plain versions ------------------------
    # gate: 1e-5 relative to the largest entry of the plain version's
    # output, as the SPD gate: the same float32 arithmetic summed in
    # another order, on well-conditioned input
    def rel(a, b):
        return float((a - b).abs().max() / b.abs().max())

    def pass_data(B, mask_frac, H=20, nx=13, nu=12, m=24):
        return fused_pass_data(rng, dev, B, mask_frac, H, nx, nu, m)

    def pass_args(d):
        roll = (d["G"], d["R"], d["Q"], d["A"], d["B"], d["qlin"], d["u"],
                d["zm"], d["x0"])
        fac = (d["G"], d["Rreg"], d["Q"], d["A"], d["B"], d["W"])
        return roll, fac

    err = {"rollout": 0.0, "factor": 0.0, "vector": 0.0, "chol_solve": 0.0}
    for B in (4, 130, 2048):
        for mask_frac in (1.0, 0.6, 0.0):
            d = pass_data(B, mask_frac)
            roll, fac = pass_args(d)
            F = cr.fused_factor(*fac)
            vec = (d["G"], d["A"], d["B"], *F, d["rx"], d["vm"])
            worst = {}
            for name, out, ref in (
                    ("rollout", cr.fused_rollout(*roll), cr.plain_rollout(*roll)),
                    ("factor", F, cr.plain_factor_pass(*fac)),
                    ("vector", cr.fused_vector(*vec),
                     cr.plain_vector_pass(*vec))):
                torch.cuda.synchronize()
                worst[name] = max(rel(a, b) for a, b in zip(out, ref))
                err[name] = max(err[name], max(float((a - b).abs().max())
                                               for a, b in zip(out, ref)))
            print(f"[fused] B={B} H=20 13/12/24 masks {mask_frac:.1f}: rel "
                  f"err rollout {worst['rollout']:.2e}, factor "
                  f"{worst['factor']:.2e}, vector {worst['vector']:.2e} "
                  f"(gate 1e-5)", flush=True)
            check(max(worst.values()) <= 1e-5, f"fused passes B={B} masks "
                  f"{mask_frac} within 1e-5 of their plain versions")
            check(bool((torch.triu(F[0], 1) == 0).all()),
                  "fused factor L has exact zeros above the diagonal")

    def spd(B, n):
        A = rng.normal(size=(B, n, n))
        return torch.as_tensor(A @ A.transpose(0, 2, 1) + n * np.eye(n),
                               dtype=f32, device=dev)

    # the rollout's padded widths and its 32-row instance
    for nx, nu, m in ((6, 4, 8), (13, 12, 32)):
        roll, _ = pass_args(pass_data(130, 0.6, nx=nx, nu=nu, m=m))
        out, ref = cr.fused_rollout(*roll), cr.plain_rollout(*roll)
        torch.cuda.synchronize()
        e = max(rel(a, b) for a, b in zip(out, ref))
        err["rollout"] = max(err["rollout"], max(
            float((a - b).abs().max()) for a, b in zip(out, ref)))
        print(f"[fused] rollout B=130 H=20 {nx}/{nu}/{m}: rel err {e:.2e} "
              f"(gate 1e-5)", flush=True)
        check(e <= 1e-5, f"rollout {nx}/{nu}/{m} within 1e-5 of its plain "
              f"version")

    # chol_solve on each side of its compile-time widths (12, 18, 30; the
    # wide body past 30), both substitution layouts (k < 8, k >= 8, past
    # 32 columns) and batches around the use_pallas scan's 256
    ks, Bs = (1, 7, 8, 13, 30), (1, 255, 256, 257, 2049)
    for n in (1, 5, 11, 12, 13, 18, 30, 31, 64):
        worst = 0.0
        for B in Bs:
            M = spd(B, n)
            for k in ks:
                r = torch.as_tensor(rng.normal(size=(B, n, k)), dtype=f32,
                                    device=dev)
                X = cuda_chol.chol_solve(M, r)
                Xp = chol.plain_chol_solve(M, r)
                torch.cuda.synchronize()
                e = rel(X, Xp)
                worst = max(worst, e)
                err["chol_solve"] = max(err["chol_solve"],
                                        float((X - Xp).abs().max()))
                check(e <= 1e-5, f"chol_solve n={n} B={B} k={k} within "
                      f"1e-5 ({e:.2e})")
        print(f"[chol_solve] n={n}, k in {ks}, B in {Bs}: worst rel err "
              f"{worst:.2e} (gate 1e-5)", flush=True)
    M = spd(5, 12)
    M[2, 4, 4] = -3.0
    X = cuda_chol.chol_solve(M, torch.ones(5, 12, 13, device=dev))
    Xp = chol.plain_chol_solve(M, torch.ones(5, 12, 13, device=dev))
    nan_ok = bool(X[2].isnan().all() & Xp[2].isnan().all())
    fin_ok = bool(X[[0, 1, 3, 4]].isfinite().all())
    print(f"[chol_solve] non-SPD lane NaN from kernel and plain {nan_ok}, "
          f"other lanes finite {fin_ok}", flush=True)
    check(nan_ok and fin_ok, "chol_solve's non-SPD lane is NaN, the rest "
          "finite")

    # ---- 13. the paths --------------------------------------------------------
    B, H = x0.shape[0], 20
    mpc = dict(horizon=H, dt=0.025)
    cfg_f = EngineConfig(mpc=MpcConfig(**mpc, backend="riccati_fused"),
                         solver=SolverConfig())
    check(planner.effective_backend(cfg_f, dev) == "riccati_fused",
          "riccati_fused resolves to itself")
    for f in passes:
        f.launches = 0
    torch.cuda.synchronize()
    cold = planner.plan(cfg_f, x0, refs)
    torch.cuda.synchronize()
    plan_launches = counts()
    print(f"[fused] main path: plan(backend='riccati_fused') B={B} H={H} "
          f"cold: launches rollout/factor/vector {plan_launches}", flush=True)
    check(all(n > 0 for n in plan_launches), "the fused plan launched each "
          "of the three kernels")
    conv = float(cold.sol.converged.float().mean())
    agree = ((cold.sol.iters == plain_cold.sol.iters)
             & (cold.sol.converged == plain_cold.sol.converged))
    df = float((cold.forces - plain_cold.forces).abs()[agree].max())
    ftol = 1e-3 * max(1.0, float(plain_cold.forces.abs().max()))
    print(f"[fused] cold plan: converged {conv:.4f}, converged/iters agree "
          f"with the plain plan on {float(agree.float().mean()):.4f} of "
          f"lanes, max|dforce| {df:.3g} (tol {ftol:.3g})", flush=True)
    check(conv >= 0.99 and float(agree.float().mean()) >= 0.995
          and df <= ftol, "fused plan agrees with the plain plan")
    # phase 3's production-shape gate on the plan's stage QP, in units of
    # its largest force (planner forces are O(100) N, phase 3's u O(1))
    qp = planner.stage_qp(cfg_f, x0, refs)
    scale = max(1.0, float(plain_cold.forces.abs().max()))
    compare_solve(cr.solve_stage_qp_fused, qp, cfg_f.solver, None,
                  f"fused stage QP of the plan B={B} H={H} cold",
                  2e-4 * scale, 0.995)
    warm = riccati.WarmStart(u=cold.forces.reshape(B, H, 12),
                             z=cold.sol.z.reshape(B, H, -1),
                             s=cold.sol.s.reshape(B, H, -1),
                             valid=torch.ones(B, dtype=torch.bool, device=dev))
    compare_solve(cr.solve_stage_qp_fused, planner.stage_qp(cfg_f, x1, refs1),
                  cfg_f.solver, warm,
                  f"fused stage QP of the plan B={B} H={H} warm replan",
                  2e-4 * scale, 0.995)
    replan = planner.plan(cfg_f, x1, refs1, warm=warm)
    print(f"[fused] warm replan: converged "
          f"{float(replan.sol.converged.float().mean()):.4f}, mean iters "
          f"{float(replan.sol.iters.float().mean()):.3f} (cold "
          f"{float(cold.sol.iters.float().mean()):.3f})", flush=True)
    check(float(replan.sol.converged.float().mean()) >= 0.99
          and float(replan.sol.iters.float().mean())
          < float(cold.sol.iters.float().mean()), "fused warm replan")
    # base_box: the fused passes have no state rows -> the resident kernel
    cfg_fb = EngineConfig(mpc=MpcConfig(**mpc, backend="riccati_fused",
                                        base_box=True), solver=SolverConfig())
    r0, f0 = cr.solve_stage_qp_resident.launches, counts()
    boxed = planner.plan(cfg_fb, x0, refs)
    torch.cuda.synchronize()
    rerouted = (cr.solve_stage_qp_resident.launches == r0 + 1
                and counts() == f0)
    print(f"[fused] base_box plan rerouted to the resident kernel "
          f"{rerouted}, converged "
          f"{float(boxed.sol.converged.float().mean()):.4f}", flush=True)
    check(rerouted, "riccati_fused + base_box runs the resident kernel")
    golden(cfg_f, " fused")

    # the scan with use_pallas: every 12x12 solve through chol_solve
    Bp = 256
    xp, refs_p = x0[:Bp], refs._replace(**{
        k: v[:Bp] for k, v in refs._asdict().items() if v is not None})
    cfg_s = EngineConfig(mpc=MpcConfig(**mpc, backend="riccati"),
                         solver=SolverConfig())
    cfg_sp = dataclasses.replace(cfg_s, solver=SolverConfig(use_pallas=True))
    cuda_chol.chol_solve.launches = 0
    torch.cuda.synchronize()
    out_p = planner.plan(cfg_sp, xp, refs_p)
    torch.cuda.synchronize()
    solve_launches = cuda_chol.chol_solve.launches
    out_s = planner.plan(cfg_s, xp, refs_p)
    agree = (out_p.sol.iters == out_s.sol.iters) & (
        out_p.sol.converged == out_s.sol.converged)
    df = float((out_p.forces - out_s.forces).abs()[agree].max())
    ftol = 1e-3 * max(1.0, float(out_s.forces.abs().max()))
    print(f"[pallas] main path: plan(backend='riccati', use_pallas=True) "
          f"B={Bp} H={H}: {solve_launches} chol_solve launches, converged "
          f"{float(out_p.sol.converged.float().mean()):.4f}, iters agree with "
          f"use_pallas=False on {float(agree.float().mean()):.4f} of lanes, "
          f"max|dforce| {df:.3g} (tol {ftol:.3g})", flush=True)
    check(solve_launches > 0, "use_pallas launched chol_solve")
    check(float(agree.float().mean()) >= 0.995 and df <= ftol,
          "use_pallas agrees with the default path")

    # the condensed backend against the resident plan, at the solver
    # tolerance the cross-backend gates need (the JAX suite's gates,
    # tests/test_planner.py: states within 5e-3, per-knot force sums 5 N)
    sol_c = SolverConfig(iters=40, reltol=1e-6, abstol=1e-5)
    cfg_c = EngineConfig(mpc=MpcConfig(**mpc, backend="condensed"),
                         solver=sol_c)
    cfg_r = EngineConfig(mpc=MpcConfig(**mpc), solver=sol_c)
    out_c = planner.plan(cfg_c, xp, refs_p)
    out_r = planner.plan(cfg_r, xp, refs_p)
    both = out_c.sol.converged & out_r.sol.converged
    dxs = float((out_c.states - out_r.states).abs()[both].max())
    dfs = float((out_c.forces.sum(-2) - out_r.forces.sum(-2)).abs()[both]
                .max())
    print(f"[condensed] plan B={Bp} H={H} (n=240): converged "
          f"{float(out_c.sol.converged.float().mean()):.4f} (resident "
          f"{float(out_r.sol.converged.float().mean()):.4f}), max|dstate| "
          f"{dxs:.3g} (gate 5e-3), max|d sum of forces| {dfs:.3g} N (gate 5)",
          flush=True)
    check(float(both.float().mean()) >= 0.99, "condensed and resident "
          "converged")
    check(dxs <= 5e-3 and dfs <= 5.0, "condensed agrees with resident")

    # ---- 14. timing -------------------------------------------------------
    rates = []
    for _ in range(3):
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(5):
            planner.plan(cfg_f, x0, refs)
        torch.cuda.synchronize()
        rates.append(B * 5 / (time.perf_counter() - t))
    rate_f = float(np.median(rates))
    print(f"[time] {card}: plan B={B} H={H} cold: fused {rate_f:.1f} "
          f"solves/s, resident {rate_resident:.1f} solves/s (phase 6), "
          f"median of 3 bursts; {sum(plan_launches)} fused kernel launches "
          f"a plan {plan_launches}", flush=True)

    d = pass_data(B, 0.6)
    roll, fac = pass_args(d)
    F = cr.fused_factor(*fac)
    vec = (d["G"], d["A"], d["B"], *F, d["rx"], d["vm"])
    works = {
        "rollout": (lambda: cr.fused_rollout(*roll),
                    lambda: cr.plain_rollout(*roll)),
        "factor": (lambda: cr.fused_factor(*fac),
                   lambda: cr.plain_factor_pass(*fac)),
        "vector": (lambda: cr.fused_vector(*vec),
                   lambda: cr.plain_vector_pass(*vec))}
    rec = {}
    for name, (kern, plain) in works.items():
        nbytes, flops = pass_work(name, B, H)
        (ms, w), (pms, pw) = call_ms(kern, 20), call_ms(plain, 5)
        b = bound(nbytes, flops)
        rec[name] = (w.ms, pw.ms, b, None)
        print(f"[time] {card}: fused {name} B={B} H={H}: device time "
              f"{w.ms:.4f} ms (window total {w.total_ms:.4f} ms, "
              f"{w.share:.2%} of launches recorded; plain {pw.ms:.4f} ms), "
              f"CUDA events {ms:.4f} ms (plain {pms:.4f} ms); bound "
              f"{b[0]:.4f} ms ({b[1]}: {nbytes / 1e6:.1f} MB, "
              f"{flops / 1e9:.3f} GFLOP), kernel at "
              f"{100 * b[0] / w.ms:.2f}% of bound", flush=True)

    # chol_solve at the use_pallas scan's shape (B=256: k=13, the gains,
    # and k=1, the feed-forward, one and two launches a knot of an
    # iteration) and at B=2048; the record takes B=256, k=13
    n = 12
    for Bc in (256, 2048):
        M = spd(Bc, n)
        for k in (13, 1):
            r = torch.as_tensor(rng.normal(size=(Bc, n, k)), dtype=f32,
                                device=dev)
            (ms, w), (pms, pw), (lms, lw) = (
                call_ms(lambda: cuda_chol.chol_solve(M, r)),
                call_ms(lambda: chol.plain_chol_solve(M, r)),
                call_ms(lambda: torch.linalg.solve(M, r)))
            # M's lower triangle is read (as the factor's), rhs read, X
            # written
            b = bound(4 * Bc * (n * (n + 1) // 2 + 2 * n * k),
                      Bc * (n ** 3 / 3 + 2 * n * n * k))
            if (Bc, k) == (Bp, 13):
                rec["chol_solve"] = (w.ms, pw.ms, b, lw.ms)
            print(f"[time] {card}: chol_solve B={Bc} n={n} k={k}: device "
                  f"time {w.ms:.5f} ms (window total {w.total_ms:.5f} ms, "
                  f"{w.share:.2%} of launches recorded), plain {pw.ms:.5f} "
                  f"ms, torch.linalg.solve {lw.ms:.5f} ms; CUDA events "
                  f"{ms:.5f} / {pms:.5f} / {lms:.5f} ms; bound {b[0]:.6f} ms "
                  f"({b[1]})", flush=True)

    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(3):
        planner.plan(cfg_c, xp, refs_p)
    torch.cuda.synchronize()
    ms_c = (time.perf_counter() - t) / 3 * 1e3
    print(f"[time] {card}: condensed plan B={Bp} H={H} (n=240, "
          f"SolverConfig(iters=40, reltol=1e-6, abstol=1e-5)): {ms_c:.2f} ms "
          f"a plan, {Bp / ms_c * 1e3:.1f} solves/s (mean of 3, host clock)",
          flush=True)

    src = "apf_quadruped_tpu_torch/csrc/fused_riccati.cu"
    out = []
    for name, line, launches in (("rollout", 135, plan_launches[0]),
                                 ("factor", 185, plan_launches[1]),
                                 ("vector", 234, plan_launches[2])):
        dms, pdms, b, lib = rec[name]
        out.append({"name": f"fused_{name}", "route": "cuda", "source": src,
                    "replaces": f"apf_quadruped_tpu/ops/pallas_riccati.py:"
                                f"{line}",
                    "launches": launches, "max_abs_err": err[name],
                    "ms": dms, "plain_ms": pdms, "bound_ms": b[0],
                    "bound_by": b[1], "library_ms": lib})
    dms, pdms, b, lib = rec["chol_solve"]
    out.append({"name": "chol_solve", "route": "cuda",
                "source": "apf_quadruped_tpu_torch/csrc/spd_chol.cu",
                "replaces": "apf_quadruped_tpu/ops/pallas_chol.py:37",
                "launches": solve_launches, "max_abs_err": err["chol_solve"],
                "ms": dms, "plain_ms": pdms, "bound_ms": b[0],
                "bound_by": b[1], "library_ms": lib})
    return out


def compare_solve(solver, qp, cfg_s, warm, tag, atol, min_frac):
    """`solver` against the plain version on the card; returns the
    largest |du|, |dx| over the lanes compared."""
    import torch

    from apf_quadruped_tpu_torch.ops import riccati

    ref = riccati.solve_stage_qp(qp, cfg_s, warm)
    out = solver(qp, cfg_s, warm)
    torch.cuda.synchronize()
    agree = (out.iters == ref.iters) & (out.converged == ref.converged)
    # u/x are compared where both converged at the same iteration: an
    # unconverged lane stops at an arbitrary interior iterate
    same = agree & ref.converged
    err = torch.maximum((out.u - ref.u).abs().amax(dim=(-1, -2)),
                        (out.x - ref.x).abs().amax(dim=(-1, -2)))[same]
    frac = float(agree.float().mean())
    within = float((err <= atol).float().mean())
    conv = float(ref.converged.float().mean())
    PARITY.append((tag, int((~agree).sum()), agree.numel(),
                   int((err > atol).sum()), float(err.max()), atol))
    print(f"[kernel] {tag}: conv {conv:.3f}, iters mismatches "
          f"{int((~agree).sum())}/{agree.numel()}, max|du|,|dx| "
          f"{float(err.max()):.3g}, lanes beyond atol {atol:g}: "
          f"{int((err > atol).sum())}", flush=True)
    check(conv >= 0.99, f"{tag}: plain version converged on >= 99%")
    check(frac >= min_frac, f"{tag}: iters/converged agree on "
          f"{frac:.4f} of lanes (need {min_frac})")
    check(within >= min_frac, f"{tag}: u/x within {atol} on "
          f"{within:.4f} of lanes (need {min_frac})")
    if min_frac < 1.0:
        # every lane, against the float64 solution: the kernel is at
        # most 10x as far from it as the plain version in float32
        qp64 = qp._replace(**{f: v.double() for f, v in
                              qp._asdict().items() if v is not None})
        warm64 = None if warm is None else warm._replace(
            u=warm.u.double(), z=warm.z.double(), s=warm.s.double())
        r64 = riccati.solve_stage_qp(qp64, cfg_s, warm64)

        def dist(sol):
            return torch.maximum(
                (sol.u.double() - r64.u).abs().amax(dim=(-1, -2)),
                (sol.x.double() - r64.x).abs().amax(dim=(-1, -2)))[same]
        worst = float((dist(out) - 10 * dist(ref)).max())
        print(f"[kernel] {tag}: max over lanes of |kernel - f64| - "
              f"10 |plain - f64| = {worst:.3g} (limit {atol:g})",
              flush=True)
        check(worst <= atol, f"{tag}: kernel within 10x the plain "
              f"version's float32 error on every lane")
    return float(err.max())


def loop_counters():
    """The launch counters of the closed loop's kernels, by record name."""
    from apf_quadruped_tpu_torch.ops import cuda_chol, cuda_riccati

    from apf_quadruped_tpu_torch.ops import cuda_qp

    return {"spd_chol_factor": cuda_chol.chol_factor,
            "spd_chol_sub": cuda_chol.chol_sub,
            "resident_ipm": cuda_riccati.solve_stage_qp_resident,
            "resident_qp": cuda_qp.solve_qp_resident}


def zero_launches():
    for f in loop_counters().values():
        f.launches = 0


def read_launches():
    return {k: f.launches for k, f in loop_counters().items()}


def named_leaves(prefix, tree):
    """(dotted name, tensor) of each leaf of a NamedTuple tree."""
    for name, value in tree._asdict().items():
        key = f"{prefix}.{name}"
        if hasattr(value, "_asdict"):
            yield from named_leaves(key, value)
        elif value is not None:
            yield key, value


# the CycleMetrics that are a share of the cycle's ticks (or leg-ticks) a
# flag was set in: the WBC's convergence, a foot slipping, an early
# touch-down latched; leg-ticks per tick
TICK_SHARES = {"qp_converged": 1, "slip_ticks": 1, "early_td_frac": 4}
# the twins of the closed-loop goldens (tests/data/_golden.py TWINS and
# F32_TWINS): the JAX float64 run from a start moved by +-1e-12 rad in q or
# 1e-14 m in the base position, and the JAX float32 run from a start moved
# by one float32 ulp
F64_TWINS = ("f64p", "f64m", "f64b")
F32_TWINS = ("f32p", "f32m", "f32b")


def golden_gate(g, head, trees, skip=(), ticks=None):
    """Hold each leaf of `trees` ({"state": LoopState, "metrics":
    CycleMetrics}) to the JAX package's float32 run, the golden's keys
    "f32.<head><prefix>.<path>", but those in `skip`.  Gate per leaf:
    |port - JAX f32| <= 5 spread + 1e-4 (1 + |JAX f64|max), the spread the
    largest of the golden's samples of how far the loop carries a
    rounding: |JAX f32 - JAX f64|, each float64 twin's distance from JAX
    f64 and each float32 twin's from JAX f32 (tests/data/_golden.py
    TWINS and F32_TWINS, where the golden has them).  The port's float32
    and the JAX package's float32 are two float32 roundings of one float64
    trajectory, and over 200 ticks of stiff penalty contact their spread
    is the spread between float32 and float64, not float32 epsilon; where
    the loop turns chaotic, or meets a branch that a rounding decides,
    that one sample is no bound, and the twins (the start moved by 1e-12
    rad in float64, by one ulp in float32) may lie farther apart.  An MPC
    iteration count may flip by one, and with `ticks` (the cycle's ticks;
    phase 24) a share of ticks by one tick (TICK_SHARES), counted in
    whole ticks: a tick's flag decided at its threshold, as a WBC solve
    that converges at its tolerance, is decided by rounding.
    Returns the worst (diff / gate, key)."""
    from apf_quadruped_tpu_torch import convert

    worst = (0.0, "")
    for prefix, tree in trees.items():
        stem = f"f32.{head}{prefix}."
        keys = [k for k in g if k.startswith(stem)]
        check(keys, f"the golden has {stem}*")
        for key in (k for k in keys if k not in skip):
            obj = tree
            for part in key[len(stem):].split("."):
                obj = getattr(obj, part)
            port = convert.to_numpy(obj).astype(np.float64)
            ref32 = g[key].astype(np.float64)
            ref64 = g["f64" + key[3:]].astype(np.float64)
            diff = float(np.abs(port - ref32).max())
            spread = max([float(np.abs(ref32 - ref64).max())]
                         + [float(np.abs(g[t + key[3:]] - ref).max())
                            for ts, ref in ((F64_TWINS, ref64),
                                            (F32_TWINS, ref32))
                            for t in ts if t + key[3:] in g])
            gate = 5.0 * spread + 1e-4 * (1.0 + float(np.abs(ref64).max()))
            if g[key].dtype.kind in "iu":
                gate = max(gate, 1.0)     # an MPC iteration count may flip
            share = TICK_SHARES.get(key.rsplit(".", 1)[1])
            if ticks and prefix == "metrics" and share:
                # in whole ticks: a float32 share is a tick count rounded
                unit = 1.0 / (share * ticks)
                diff = round(diff / unit) * unit
                gate = max(gate, unit)
            worst = max(worst, (diff / gate, key))
            check(diff <= gate, f"{key}: port vs JAX float32 {diff:.3g} "
                  f"> gate {gate:.3g}")
    return worst


def resumable_sweep(card, main_path):
    """Phase 15: sweep.run_resumable on phase 9(b)'s configuration and
    scenarios, one cycle a chunk, stopped by its test hook after the first
    chunk and resumed from the checkpoint; every final LoopState leaf and
    every metric must equal phase 9(b)'s run bit for bit."""
    import tempfile

    import torch

    from apf_quadruped_tpu_torch.runtime import sweep

    cfg, scn = main_path["cfg"], main_path["scn"]
    n, B = main_path["metrics"].com.shape[1], scn.target_xy.shape[0]
    zero_launches()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as d:
        try:
            sweep.run_resumable(cfg, scn, n, chunk=1, ckpt_dir=d,
                                _crash_after=1)
        except RuntimeError as e:
            if "simulated preemption after 1 cycles" not in str(e):
                raise
        else:
            check(False, "run_resumable stops after its first chunk")
        killed = read_launches()
        st, m = sweep.run_resumable(cfg, scn, n, chunk=1, ckpt_dir=d)
        torch.cuda.synchronize()
        sizes = {p.name: p.stat().st_size for p in Path(d).iterdir()}
    wall = time.perf_counter() - t0
    launches = read_launches()
    per_chunk = [sizes[sweep.CURSOR] + sizes[f"metrics-{c:08d}.pt"]
                 for c in range(n)]
    print(f"[resume] {card}: run_resumable B={B}, {n} cycles, chunk 1, "
          f"stopped after chunk 1 and resumed, in {wall:.1f} s ({n} cycles "
          f"in {main_path['wall']:.1f} s in phase 9(b)); checkpoint bytes a "
          f"chunk {per_chunk} (cursor {sizes[sweep.CURSOR]}); launches after "
          f"the stop {killed}, after the resume {launches}", flush=True)
    check(all(0 < killed[k] < launches[k] for k in launches),
          "the stopped run and the resumed run each launched every kernel")
    check(len(set(per_chunk)) == 1, "the bytes a chunk do not grow")
    pairs = (list(zip(named_leaves("state", st),
                      named_leaves("state", main_path["states"])))
             + list(zip(named_leaves("metrics", m),
                        named_leaves("metrics", main_path["metrics"]))))
    differ = [(ka, a, b) for (ka, a), (_, b) in pairs
              if a.dtype != b.dtype or not torch.equal(a, b)]
    if differ:
        key, a, b = differ[0]
        print(f"[resume] first leaf that differs: {key}, max|diff| "
              f"{float((a.double() - b.double()).abs().max()):.3g}; "
              f"{len(differ)} of {len(pairs)} leaves differ", flush=True)
    print(f"[resume] every one of {len(pairs)} LoopState and CycleMetrics "
          f"leaves equal to phase 9(b)'s bit for bit: {not differ}",
          flush=True)
    check(not differ, "the resumed sweep equals the uninterrupted one")


def zoo_robots(dev, card):
    """Phase 16: the zoo robots through the `run` command's closed loop on
    the card (flat ground, target (0, 1.5), one scenario, one cycle,
    float32), against the JAX package's runs (tests/data/zoo_golden.npz)
    with phase 9(c)'s per-leaf gate."""
    import torch

    from apf_quadruped_tpu_torch import __main__ as cli
    from apf_quadruped_tpu_torch.runtime import sweep

    with np.load(ROOT / "tests" / "data" / "zoo_golden.npz") as f:
        g = {k: f[k] for k in f.files}
    for name in ("anymal", "hyq"):
        cfg = sweep.cli_config(robot=name)
        zero_launches()
        t0 = time.perf_counter()
        st, m, _, _ = cli.run_closed_loop(cfg, target="0,1.5", cycles=1,
                                          device=dev)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = read_launches()
        worst = golden_gate(g, f"{name}.", {"state": st, "metrics": m})
        print(f"[zoo] {card}: {name} (mass {cfg.robot.mass} kg), one cycle "
              f"B=1 in {wall:.1f} s: CoM {m.com[0, -1].tolist()}, R22 "
              f"{float(st.sim.R_wb[0, 2, 2]):.5f}, qp_converged "
              f"{float(m.qp_converged.mean()):.4f}; launches {launches}; "
              f"vs JAX float32 golden: every leaf within its gate, worst "
              f"{worst[1]} at {worst[0]:.3f} of its gate", flush=True)
        check(all(v > 0 for v in launches.values()),
              f"{name}'s loop launched every kernel")


def long_horizon(dev, card):
    """Phase 17: the crawl plan's horizon, H=40 (the `run --gait crawl`
    config), through the resident kernel at B=64 against the plain
    version with phase 3's production gate; the kernel's time at H=40; then
    the `bench` command once."""
    import dataclasses

    import torch

    from apf_quadruped_tpu_torch import __main__ as cli
    from apf_quadruped_tpu_torch import gait, planner, problems
    from apf_quadruped_tpu_torch.ops import cuda_riccati, riccati
    from apf_quadruped_tpu_torch.runtime import sweep

    cfg = sweep.cli_config(gait="crawl")
    H = cfg.mpc.horizon
    check(H == 40, "crawl plans 40 knots")

    def crawl_problem(B):
        x0, refs = problems.bench_problem(cfg, B, seed=2, device=dev)
        return x0, refs._replace(contacts=gait.horizon_contacts(
            torch.full((B,), 4, dtype=torch.int32, device=dev),
            torch.zeros(B, device=dev), cfg.mpc.dt, H,
            torch.full((B,), cfg.gait.crawl_cycle, device=dev)))

    B = 64
    x0, refs = crawl_problem(B)
    cuda_riccati.solve_stage_qp_resident.launches = 0
    out = planner.plan(cfg, x0, refs)
    torch.cuda.synchronize()
    launched = cuda_riccati.solve_stage_qp_resident.launches
    cfg_plain = cfg.replace(mpc=dataclasses.replace(cfg.mpc,
                                                    backend="riccati"))
    ref = planner.plan(cfg_plain, x0, refs)
    agree = ((out.sol.iters == ref.sol.iters)
             & (out.sol.converged == ref.sol.converged))
    df = float((out.forces - ref.forces).abs()[agree].max())
    ftol = 1e-3 * max(1.0, float(ref.forces.abs().max()))
    print(f"[h40] crawl plan B={B} H={H}: launches {launched}, converged "
          f"{float(out.sol.converged.float().mean()):.4f}, mean iters "
          f"{float(out.sol.iters.float().mean()):.3f}; vs the plain plan: "
          f"converged/iters agree on {float(agree.float().mean()):.4f} of "
          f"lanes, max|dforce| {df:.3g} (tol {ftol:.3g})", flush=True)
    check(launched == 1, "the H=40 plan launched the resident kernel")
    check(float(agree.float().mean()) >= 0.995 and df <= ftol,
          "the H=40 plan agrees with the plain plan")
    scale = max(1.0, float(ref.forces.abs().max()))
    compare_solve(cuda_riccati.solve_stage_qp_resident,
                  planner.stage_qp(cfg, x0, refs), cfg.solver, None,
                  f"stage QP of the crawl plan B={B} H={H} (in units of "
                  f"its largest force)", 2e-4 * scale, 0.995)
    for Bt in (64, 2048):
        qp = planner.stage_qp(cfg, *crawl_problem(Bt))
        ms_k = event_ms(lambda: cuda_riccati.solve_stage_qp_resident(
            qp, cfg.solver), reps=20)
        ms_p = event_ms(lambda: riccati.solve_stage_qp(qp, cfg.solver),
                        reps=3)
        print(f"[h40] {card}: resident IPM stage-QP solve B={Bt} H={H} "
              f"crawl: kernel {ms_k:.4f} ms, plain {ms_p:.3f} ms (CUDA "
              f"events)", flush=True)
    print("[bench] the bench command:", flush=True)
    cli.main(["bench"])


def sharded_sweeps(dev, card):
    """Phase 18: run_sharded over ["cuda:0"] and ["cuda:0", "cuda:0"] at
    tests/test_sweep.py's small config (B=8, one cycle) against run_batch,
    then once more inside a world-size-1 NCCL process group, where the
    gather and the stats' mean run as collectives on the card."""
    import socket

    import torch
    import torch.distributed as dist

    from apf_quadruped_tpu_torch.config import (EngineConfig, GaitConfig,
                                                MpcConfig, SimConfig,
                                                SolverConfig, WbcConfig)
    from apf_quadruped_tpu_torch.parallel import distributed
    from apf_quadruped_tpu_torch.runtime import graph, sweep

    cfg = EngineConfig(gait=GaitConfig(trot_cycle=0.1),
                       mpc=MpcConfig(horizon=4, dt=0.025),
                       sim=SimConfig(substeps=1, terrain_res=16),
                       solver=SolverConfig(iters=5),
                       wbc=WbcConfig(slack_weight_trot=1e6))
    B = 8
    scn = sweep.random_scenarios(cfg, B, seed=3, device=dev)
    d0 = "cuda:0" if dev.type == "cuda" else dev.type
    ref = sweep.run_batch(cfg, scn, 1)

    def run(tag, devices):
        zero_launches()
        res, stats = sweep.run_sharded(cfg, scn, 1, devices=devices)
        torch.cuda.synchronize()
        launches = read_launches()
        pairs = list(zip(named_leaves("result", res),
                         named_leaves("result", ref)))
        bitwise = all(torch.equal(a, b) for (_, a), (_, b) in pairs)
        dcom = float((res.final_com - ref.final_com).abs().max())
        means = {"goal_dist": res.goal_dist.mean(),
                 "fell": res.fell.float().mean(),
                 "qp_converged": res.qp_converged.mean(),
                 "slip_frac": res.slip_frac.mean()}
        dstat = max(float((stats[k] - v).abs()) for k, v in means.items())
        print(f"[shard] {tag}: run_sharded B={B} over {devices}: equal to "
              f"run_batch bit for bit {bitwise}, max|dfinal_com| {dcom:.3g} "
              f"(gate 0.05), fell {int(res.fell.sum())} (run_batch "
              f"{int(ref.fell.sum())}); stats "
              f"{json.dumps({k: float(v) for k, v in stats.items()})}, "
              f"max |stat - mean of the gathered result| {dstat:.3g}; "
              f"launches {launches}", flush=True)
        check(all(v > 0 for v in launches.values()),
              f"{tag}: the sharded run launched every kernel")
        check(res.final_com.shape == (B, 3), f"{tag}: the whole batch")
        # tests/test_sweep.py's gate: a split changes float32 reductions,
        # which this small config's closed loop carries to cm
        check(dcom <= 0.05 and int(res.fell.sum()) == int(ref.fell.sum()),
              f"{tag}: the sharded run agrees with run_batch")
        check(dstat <= 1e-5, f"{tag}: the stats are the means")
        if len(devices) == 1:
            check(bitwise, f"{tag}: one shard is run_batch")
        return res, stats

    run("one shard", [d0])
    res2, stats2 = run("two shards", [d0, d0])

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    calls = {"all_gather": 0, "all_reduce": 0}
    real = {k: getattr(dist, k) for k in calls}

    def counted(name):
        def fn(*args, **kw):
            tensors = args[0] if name == "all_gather" else [args[0]]
            check(all(t.device.type == dev.type for t in tensors),
                  f"{name} on the card")
            calls[name] += 1
            return real[name](*args, **kw)
        return fn

    distributed.ensure_initialized(f"127.0.0.1:{port}", 1, 0)
    try:
        check(dist.get_backend() == ("nccl" if dev.type == "cuda"
                                     else "gloo"), "the group runs NCCL")
        for k in calls:
            setattr(dist, k, counted(k))
        # the tick's graph captured anew with the group's threads running
        graph.clear()
        res3, stats3 = run("two shards, NCCL group of 1", [d0, d0])
    finally:
        for k, f in real.items():
            setattr(dist, k, f)
        dist.destroy_process_group()
    same = all(torch.equal(a, b) for (_, a), (_, b) in zip(
        named_leaves("r", res3), named_leaves("r", res2)))
    print(f"[shard] NCCL group of 1: collectives on the card {calls}; "
          f"result equal to the group-less run bit for bit {same}",
          flush=True)
    check(calls["all_gather"] > 0 and calls["all_reduce"] > 0,
          "the gather and the mean ran as NCCL collectives")
    check(same and all(torch.equal(stats3[k], stats2[k]) for k in stats2),
          "the group of 1 changes nothing")


def stage_bf16(dev, card, x0, refs, x1, refs1):
    """Phase 19: SolverConfig.stage_bf16, A and B at bf16 on the device:
    the bf16 instances of the resident IPM and the three fused passes
    against their plain versions on the rounded inputs, the plans through
    them, their times in turns with the float32 instances; returns their
    JSON records."""
    import dataclasses

    import torch

    from apf_quadruped_tpu_torch import convert, planner, problems
    from apf_quadruped_tpu_torch.config import (EngineConfig, MpcConfig,
                                                SolverConfig)
    from apf_quadruped_tpu_torch.ops import cuda_riccati as cr
    from apf_quadruped_tpu_torch.ops import riccati

    B, H = x0.shape[0], 20
    sol32, sol16 = SolverConfig(), SolverConfig(stage_bf16=True)
    passes = (cr.fused_rollout, cr.fused_factor, cr.fused_vector)
    rng = np.random.default_rng(19)
    err = {"resident": 0.0, "rollout": 0.0, "factor": 0.0, "vector": 0.0}

    def resident16(qp, cfg_s, warm):
        return cr.solve_stage_qp_resident(
            qp, dataclasses.replace(cfg_s, stage_bf16=True), warm)

    # (1) the resident bf16 instance against the scan on the rounded stage
    # QP at the production shape, phase 3's production gate (the kernel
    # rounds the already rounded A and B to themselves)
    for warm_on in (False, True):
        for mc in (0, 6):
            for acc in (False, True):
                q = problems.random_stage_qp(rng, B=B, H=H, NX=13, NU=12,
                                             M=24, mc=mc, acc=acc)
                qp = riccati.round_stage_bf16(convert.stage_qp(q, dev))
                warm = None
                if warm_on:
                    cold = riccati.solve_stage_qp(qp, sol32)
                    warm = riccati.WarmStart(
                        u=cold.u, z=cold.z, s=cold.s,
                        valid=torch.as_tensor(rng.uniform(size=B) < 0.75,
                                              device=dev))
                e = compare_solve(resident16, qp, sol32, warm,
                                  f"bf16 B={B} H={H} warm={warm_on} mc={mc} "
                                  f"acc={acc}", 2e-4, 0.995)
                err["resident"] = max(err["resident"], e)

    # (2) the three fused bf16 passes against their plain versions on the
    # same bf16 inputs (which widen them first), 1e-5 relative to the
    # largest entry, as phase 12
    def pass_data(Bp):
        t = fused_pass_data(rng, dev, Bp, 0.6, H)
        t.update(A16=cr.bf16_knots(t["A"]), B16=cr.bf16_knots(t["B"]))
        return t

    def pass_calls(d, A, Bm):
        """{pass: (kernel call, plain call)} on A, Bm (bf16 or float32)."""
        roll = (d["G"], d["R"], d["Q"], A, Bm, d["qlin"], d["u"], d["zm"],
                d["x0"])
        fac = (d["G"], d["Rreg"], d["Q"], A, Bm, d["W"])
        F = cr.plain_factor_pass(*fac)
        vec = (d["G"], A, Bm, *F, d["rx"], d["vm"])
        return {"rollout": (lambda: cr.fused_rollout(*roll),
                            lambda: cr.plain_rollout(*roll)),
                "factor": (lambda: cr.fused_factor(*fac),
                           lambda: cr.plain_factor_pass(*fac)),
                "vector": (lambda: cr.fused_vector(*vec),
                           lambda: cr.plain_vector_pass(*vec))}

    def rel(a, b):
        return float((a - b).abs().max() / b.abs().max())

    for Bp in (130, B):
        d = pass_data(Bp)
        worst = {}
        for name, (kern, plain) in pass_calls(d, d["A16"], d["B16"]).items():
            out, ref = kern(), plain()
            torch.cuda.synchronize()
            worst[name] = max(rel(a, b) for a, b in zip(out, ref))
            err[name] = max(err[name], max(float((a - b).abs().max())
                                           for a, b in zip(out, ref)))
        print(f"[bf16] fused passes B={Bp} H={H} 13/12/24 masks 0.6: rel err "
              f"rollout {worst['rollout']:.2e}, factor {worst['factor']:.2e}, "
              f"vector {worst['vector']:.2e} (gate 1e-5)", flush=True)
        check(max(worst.values()) <= 1e-5, f"bf16 fused passes B={Bp} "
              f"within 1e-5 of their plain versions")

    # (3) the paths: plans with stage_bf16 through "auto" (the resident
    # kernel) and "riccati_fused", cold and warm, against the scan on the
    # rounded stage QP; the kernels' launch counts from zero
    cfgs = {b: EngineConfig(mpc=MpcConfig(horizon=H, dt=0.025, backend=b),
                            solver=sol16)
            for b in ("auto", "riccati_fused")}
    launches = {}
    plans16 = {}
    for backend, cfg in cfgs.items():
        cr.solve_stage_qp_resident.launches = 0
        for f in passes:
            f.launches = 0
        torch.cuda.synchronize()
        cold = planner.plan(cfg, x0, refs)
        warm = riccati.WarmStart(u=cold.forces.reshape(B, H, 12),
                                 z=cold.sol.z.reshape(B, H, -1),
                                 s=cold.sol.s.reshape(B, H, -1),
                                 valid=torch.ones(B, dtype=torch.bool,
                                                  device=dev))
        replan = planner.plan(cfg, x1, refs1, warm=warm)
        torch.cuda.synchronize()
        launches[backend] = (cr.solve_stage_qp_resident.launches,
                             *(f.launches for f in passes))
        plans16[backend] = cold
        print(f"[bf16] main path: plan(backend={backend!r}, stage_bf16) "
              f"B={B} H={H} cold and warm: launches resident/rollout/factor/"
              f"vector {launches[backend]}", flush=True)
        if backend == "auto":
            check(launches[backend][0] == 2 and sum(launches[backend][1:])
                  == 0, "auto ran the resident kernel, once a plan")
        else:
            check(launches[backend][0] == 0
                  and all(n > 0 for n in launches[backend][1:]),
                  "riccati_fused ran the three passes")
        for tag, p, xx, rr, w in (("cold", cold, x0, refs, None),
                                  ("warm", replan, x1, refs1, warm)):
            ref = riccati.solve_stage_qp(riccati.round_stage_bf16(
                planner.stage_qp(cfg, xx, rr)), cfg.solver, w)
            conv = float(p.sol.converged.float().mean())
            agree = (p.sol.iters == ref.iters) & (
                p.sol.converged == ref.converged)
            fk = p.forces.reshape(ref.u.shape)
            df = float((fk - ref.u).abs()[agree].max())
            ftol = 1e-3 * max(1.0, float(ref.u.abs().max()))
            print(f"[bf16] {backend} {tag} plan: converged {conv:.4f}, "
                  f"iters/converged agree with the scan on the rounded stage "
                  f"QP on {float(agree.float().mean()):.4f} of lanes, "
                  f"max|dforce| {df:.3g} (tol {ftol:.3g})", flush=True)
            check(conv >= 0.99 and float(agree.float().mean()) >= 0.995
                  and df <= ftol, f"bf16 {backend} {tag} plan agrees with "
                  f"the scan on the rounded stage QP")
    for backend, cfg in cfgs.items():
        p32 = planner.plan(dataclasses.replace(cfg, solver=sol32), x0, refs)
        print(f"[bf16] {backend} cold plan, bf16 against float32 storage: "
              f"max|dforce| {float((plans16[backend].forces - p32.forces).abs().max()):.4g} N "
              f"(largest force {float(p32.forces.abs().max()):.4g} N), iters "
              f"differ on {int((plans16[backend].sol.iters != p32.sol.iters).sum())} "
              f"of {B} lanes", flush=True)

    # (4) timing, bf16 and float32 storage in turns in this process
    qp = planner.stage_qp(cfgs["auto"], x0, refs)
    res = {"float32": lambda: cr.solve_stage_qp_resident(qp, sol32),
           "bf16": lambda: cr.solve_stage_qp_resident(qp, sol16)}
    ev = {"float32": [], "bf16": []}
    for _ in range(2):
        for label in ("float32", "bf16", "bf16", "float32"):
            ev[label].append(event_ms(res[label], 10))
    ms16, ms32 = median(ev["bf16"]), median(ev["float32"])
    qpr = riccati.round_stage_bf16(qp)
    pms = event_ms(lambda: riccati.solve_stage_qp(qpr, sol32), 1)
    its = cr.solve_stage_qp_resident(qp, sol16)
    sweeps = its.iters.double() + 1.0 + its.converged.double()
    f_roll, f_fac, f_vec = knot_flops(13, 12, 24)
    flops = H * float((its.iters.double() * (f_fac + 2 * f_vec)
                       + sweeps * f_roll).sum())
    nbytes = (2 * B * H * (13 * 13 + 13 * 12)            # A, B at bf16
              + 4 * B * (H * (13 + 2 * 24) + 13          # q, mask, h, x0
                         + H * (12 + 13 + 2 * 24) + 4))  # u, x, z, s, stat
    b_res = bound(nbytes, flops)
    print(f"[time] {card}: resident IPM B={B} H={H} cold (CUDA events, "
          f"median of 4 in turns): bf16 {ms16:.4f} ms {[round(v, 4) for v in ev['bf16']]}, "
          f"float32 {ms32:.4f} ms {[round(v, 4) for v in ev['float32']]} "
          f"({100 * (ms16 / ms32 - 1):+.2f}%); plain on the rounded QP "
          f"{pms:.3f} ms; bf16 bound {b_res[0]:.4f} ms ({b_res[1]})",
          flush=True)
    rec = {"resident": (ms16, pms, b_res)}

    d = pass_data(B)
    k16, k32 = pass_calls(d, d["A16"], d["B16"]), pass_calls(d, d["A"],
                                                              d["B"])
    for name in ("rollout", "factor", "vector"):
        t = turns({"float32": k32[name][0], "bf16": k16[name][0]}, rounds=2,
                  reps=20)
        (w16, n16), (w32, n32) = (lossless_ms(t["bf16"]),
                                  lossless_ms(t["float32"]))
        e16 = event_ms(k16[name][0], 20)
        e32 = event_ms(k32[name][0], 20)
        pw = window(k16[name][1], 3)
        b16 = bound(*pass_work(name, B, H, ab_bytes=2))
        b32 = bound(*pass_work(name, B, H))
        rec[name] = (w16, pw.ms, b16)
        print(f"[time] {card}: fused {name} B={B} H={H}: "
              f"{turns_line('bf16', t['bf16'])}; "
              f"{turns_line('float32', t['float32'])}; medians of the "
              f"windows that recorded every launch ({n16} and {n32} of "
              f"{len(t['bf16'])}) bf16 {w16:.5f} ms, float32 {w32:.5f} ms "
              f"({100 * (w16 / w32 - 1):+.2f}%); CUDA events bf16 {e16:.4f} "
              f"ms, float32 {e32:.4f} ms; plain (bf16 inputs) {pw.ms:.4f} "
              f"ms; bound bf16 {b16[0]:.4f} ms ({b16[1]}, "
              f"{100 * b16[0] / w16:.2f}% of it), float32 {b32[0]:.4f} ms "
              f"({100 * b32[0] / w32:.2f}%); SM clock {span([c.split(',')[0] for c in t['clocks']])} MHz",
              flush=True)

    # the plans: device time a plan (profiler) and solves/s (host clock,
    # median of 3 bursts of 5), each backend with and without the flag
    for backend in ("auto", "riccati_fused"):
        plan_fns = {st: (lambda c=dataclasses.replace(cfgs[backend],
                                                       solver=sol):
                         planner.plan(c, x0, refs))
                    for st, sol in (("float32", sol32), ("bf16", sol16))}
        t = turns(plan_fns, rounds=1, reps=3)
        rates = {}
        for st, fn in plan_fns.items():
            r = []
            for _ in range(3):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(5):
                    fn()
                torch.cuda.synchronize()
                r.append(B * 5 / (time.perf_counter() - t0))
            rates[st] = median(r)
        print(f"[time] {card}: plan(backend={backend!r}) B={B} H={H} cold, "
              f"device time a plan: {turns_line('bf16', t['bf16'])}; "
              f"{turns_line('float32', t['float32'])}; solves/s bf16 "
              f"{rates['bf16']:.1f}, float32 {rates['float32']:.1f} (host "
              f"clock, median of 3 bursts of 5)", flush=True)

    out = []
    src = {"resident": ("resident_ipm", 551),
           "rollout": ("fused_riccati", 135), "factor": ("fused_riccati", 185),
           "vector": ("fused_riccati", 234)}
    counts = {"resident": launches["auto"][0],
              "rollout": launches["riccati_fused"][1],
              "factor": launches["riccati_fused"][2],
              "vector": launches["riccati_fused"][3]}
    for name, (lib, line) in src.items():
        ms, pms, b = rec[name]
        out.append({"name": (f"{lib}_bf16" if name == "resident"
                             else f"fused_{name}_bf16"),
                    "route": "cuda",
                    "source": f"apf_quadruped_tpu_torch/csrc/{lib}.cu",
                    "replaces": f"apf_quadruped_tpu/ops/pallas_riccati.py:"
                                f"{line}",
                    "launches": counts[name], "max_abs_err": err[name],
                    "ms": ms, "plain_ms": pms, "bound_ms": b[0],
                    "bound_by": b[1], "library_ms": None})
    return out


def replay_ms(fn, reps=50):
    """CUDA-event ms of one replay of `fn` captured alone in a CUDA graph
    (after one eager call on a side stream), mean over `reps` back-to-back
    replays: the device's time for fn, the host out of the way."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        fn()
    return event_ms(g.replay, reps)


def short_cycles(cfg, **gait):
    """cfg with every gait's cycle cut to 0.05 s (20 ticks), for the
    eager sides of phases 20 and 24, and `gait`'s fields set."""
    return cfg.replace(gait=dataclasses.replace(
        cfg.gait, trot_cycle=0.05, crawl_cycle=0.05, fixed_cycle=0.05,
        **gait))


def graphed_tick(dev, card, main_path):
    """Phase 20: the closed loop's tick replayed from a captured CUDA graph
    (runtime/graph.py), against the eager tick (loop._scan_ticks_eager)
    bit for bit at phase 9(b)'s B=64 and two cycles (cut to 20 ticks each
    for time): trot on flat ground without early touch-down, a height
    world, early touch-down, crawl, pace, adaptive, a second batch of other
    scenarios through the cached graph, and step_batch_sharded over two
    shards on one card.  Then its numbers at the CLI's sweep configuration,
    B=64 and B=1024: closed-loop cycles of 200 ticks after the capturing
    one (host clock), the capture's time and memory pool, a tick's device
    time by CUDA events over back-to-back replays and the device's idle
    share, 20-tick cycles graphed and eager in turns, and the tick's device
    time split by stage (each stage captured alone on the tick's inputs
    and replayed)."""
    import dataclasses

    import torch

    from apf_quadruped_tpu_torch import _precision, wbc
    from apf_quadruped_tpu_torch.ops import qpsolve
    from apf_quadruped_tpu_torch.parallel import mesh as mesh_mod
    from apf_quadruped_tpu_torch.runtime import graph, loop, sweep
    from apf_quadruped_tpu_torch.sim import disturbance, physics, terrain

    def leaves(tree):
        if isinstance(tree, torch.Tensor):
            return [tree]
        return [x for v in tree if v is not None for x in leaves(v)]

    def bitwise(a, b):
        la, lb = leaves(a), leaves(b)
        return len(la) == len(lb) and all(
            x.dtype == y.dtype and torch.equal(x, y) for x, y in zip(la, lb))

    # ---- (a) graphed against eager, bit for bit ---------------------------
    B, cycles = main_path["scn"].target_xy.shape[0], 2

    def case(name, seed=0):
        mode = name if name in ("crawl", "pace", "adaptive") else "trot"
        cfg = short_cycles(sweep.cli_config(gait=mode),
                           early_td=name != "trot")
        scn = sweep.random_scenarios(cfg, B, seed=seed, device=dev)
        terr = (terrain.block(cfg.sim, batch=(B,), device=dev)
                if name == "height" else sweep._terrain(cfg, scn))
        return cfg, terr, scn.target_xy, scn.dist_sched

    def two_cycles(cfg, terr, tgt, dist):
        return loop.run(cfg, loop.init(cfg, B, device=dev), terr, tgt, dist,
                        cycles)

    t0 = time.perf_counter()
    same = {}
    for name in ("trot", "height", "early_td", "crawl", "pace",
                 "adaptive"):
        args = case(name)
        graph.clear()
        graphed = two_cycles(*args)
        one = len(tick_graphs()) == 1
        with eager_ticks():
            same[name] = one and bitwise(graphed, two_cycles(*args))
    graph.clear()
    first = two_cycles(*case("early_td"))
    kept = [t.clone() for t in leaves(first)]
    cached = {id(e) for e in graph.entries()}
    args = case("early_td", seed=1)
    second = two_cycles(*args)
    with eager_ticks():
        eager_second = two_cycles(*args)
    same["other scenarios through the cached graph"] = (
        {id(e) for e in graph.entries()} == cached
        and bitwise(second, eager_second) and bitwise(first, kept))
    cfg = short_cycles(sweep.cli_config())
    scn = sweep.random_scenarios(cfg, B, seed=2, device=dev)
    m2 = mesh_mod.scenario_mesh(["cuda:0", "cuda:0"])

    def sharded():
        return sweep.step_batch_sharded(
            cfg, mesh_mod.shard_batch(m2, scn),
            mesh_mod.shard_batch(m2, sweep.init_batch(cfg, scn)), cycles, m2)

    graph.clear()
    graphed = sharded()
    one = len(tick_graphs()) == 1
    with eager_ticks():
        same["two shards on one card"] = one and bitwise(graphed, sharded())
    print(f"[graph] B={B}, {cycles} cycles of 20 ticks, graphed against "
          f"eager, every LoopState leaf and CycleMetrics field equal bit for "
          f"bit: {json.dumps(same)} ({time.perf_counter() - t0:.1f} s)",
          flush=True)
    check(all(same.values()), "the graphed tick equals the eager tick")

    # ---- (b) the numbers ----------------------------------------------------
    cfg = sweep.cli_config()
    n_ticks = int(round(cfg.gait.trot_cycle / cfg.sim.dt))
    prof = main_path["profiles"]
    print(f"[graph] {card}: launch calls the host makes a tick (phase 10, "
          f"B={B}): graphed {prof['graphed']['per_tick']:.1f} "
          f"({prof['graphed']['calls']} in a 20-tick cycle), eager "
          f"{prof['eager']['per_tick']:.1f}", flush=True)
    check(prof["graphed"]["per_tick"] <= 5,
          "the host makes a handful of launch calls a graphed tick")
    seen = {}

    def spy(cfg_, cyc, carry, n):
        seen.update(cyc=cyc, carry=carry)
        return real(cfg_, cyc, carry, n)

    for Bn in (64, 1024):
        scn = sweep.random_scenarios(cfg, Bn, seed=0, device=dev)
        st = sweep.init_batch(cfg, scn)
        graph.clear()
        torch.cuda.synchronize()
        t = time.perf_counter()
        real = loop._scan_ticks
        loop._scan_ticks = spy
        try:
            st, _ = sweep.step_batch(cfg, scn, st, 1)
        finally:
            loop._scan_ticks = real
        torch.cuda.synchronize()
        capturing = time.perf_counter() - t
        (entry,) = tick_graphs()
        # the device's span of each cycle's ticks: CUDA events around
        # graph.scan (the copies in, the replays, the copies out)
        walls, spans = [], []
        real_scan = graph.scan

        def timed_scan(*args):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = real_scan(*args)
            end.record()
            spans.append((start, end))
            return out

        graph.scan = timed_scan
        try:
            for _ in range(2):
                t = time.perf_counter()
                st, met = sweep.step_batch(cfg, scn, st, 1)
                torch.cuda.synchronize()
                walls.append(time.perf_counter() - t)
        finally:
            graph.scan = real_scan
        spans = [a.elapsed_time(b) / 1e3 for a, b in spans]
        wall = median(walls)
        ms_tick = 1e3 * wall / n_ticks
        idle = [100 * (1 - sp / w) for sp, w in zip(spans, walls)]

        def replay_cycle():
            entry.k.zero_()
            for _ in range(n_ticks):
                entry.graph.replay()

        dev_ms = event_ms(replay_cycle, reps=3) / n_ticks
        print(f"[graph] {card}: closed loop B={Bn} at the CLI's sweep "
              f"configuration, graphed: {Bn * n_ticks / wall:.1f} "
              f"scenario-ticks/s, {ms_tick:.3f} ms a tick (cycles of "
              f"{n_ticks} ticks after the capturing one, "
              f"{[round(w, 4) for w in walls]} s, host clock; the "
              f"capturing cycle {capturing:.3f} s); qp_converged mean "
              f"{float(met.qp_converged.mean()):.4f}; the device's span of a cycle's ticks "
              f"{[round(v, 4) for v in spans]} s (CUDA events around "
              f"graph.scan), {1e3 * median(spans) / n_ticks:.4f} ms a tick; "
              f"the rest of the cycle (its head's replay: navigation and "
              f"plan; the metrics) "
              f"{[round(w - v, 4) for w, v in zip(walls, spans)]} s, "
              f"{[round(v, 2) for v in idle]}% of a cycle, in which the "
              f"ticks leave the device idle; a tick's device time "
              f"{dev_ms:.4f} ms (CUDA events, "
              f"3 x {n_ticks} back-to-back replays)", flush=True)
        check(bool(torch.isfinite(met.com).all()), f"B={Bn} finite")

        # in turns: 20-tick cycles, eager, graphed, graphed, eager
        c20 = short_cycles(cfg)
        st0 = sweep.init_batch(c20, scn)

        def cycle20():
            sweep.step_batch(c20, scn, st0, 1)
            torch.cuda.synchronize()

        cycle20()
        times = {"eager": [], "graphed": []}
        for label in ("eager", "graphed", "graphed", "eager"):
            t = time.perf_counter()
            if label == "eager":
                with eager_ticks():
                    cycle20()
            else:
                cycle20()
            times[label].append(time.perf_counter() - t)
        g_ms, e_ms = (1e3 * median(times[k]) / 20 for k in ("graphed",
                                                            "eager"))
        print(f"[graph] {card}: 20-tick cycles B={Bn} in turns (eager, "
              f"graphed, graphed, eager; host clock, the plan's share "
              f"included): graphed {Bn * 1e3 / g_ms:.1f} scenario-ticks/s, "
              f"{g_ms:.3f} ms a tick "
              f"{[round(v, 4) for v in times['graphed']]} s; "
              f"eager {Bn * 1e3 / e_ms:.1f} scenario-ticks/s, {e_ms:.3f} ms "
              f"a tick {[round(v, 4) for v in times['eager']]} s; "
              f"{e_ms / g_ms:.2f}x", flush=True)

        # the tick's device time by stage, each stage captured alone on
        # the inputs of the cycle's first tick
        cyc, carry = seen["cyc"], seen["carry"]
        sim0 = carry[0]
        k = torch.zeros(1, dtype=torch.int64, device=dev)
        with _precision.highest_precision():
            wst, ref, td_flag, td_pos = loop._tick_refs(cfg, cyc, carry, k)
            qp, _ = wbc._build_qp(cfg, wst, ref)
            out = wbc._solve_eager(cfg, wst, ref)

            def phys():
                fd, ff = disturbance.eval_links(cyc.dist_sched, sim0.t)
                return physics.step(cfg, sim0, out.tau, cyc.terr,
                                    f_dist=fd, f_feet=ff)

            sim1, cinfo = phys()
            trace = loop._trace_buffers(sim0.q.shape[0], 1, sim0.q.dtype,
                                        dev)

            def tail():
                new, row = loop._tick_tail(
                    cfg, (sim1,) + carry[1:2] + (td_flag, td_pos,
                                                 cinfo.in_contact,
                                                 carry[5]), out, cinfo, ref)
                for buf, v in zip(trace, row):
                    buf.index_copy_(1, k, v.unsqueeze(1))
                return new

            ms = {"references (gait phase, swing, MPC refs)":
                  replay_ms(lambda: loop._tick_refs(cfg, cyc, carry, k)),
                  "WBC build": replay_ms(lambda: wbc._build_qp(cfg, wst,
                                                               ref)),
                  "QP (solve_qp)": replay_ms(
                      lambda: qpsolve._solve_qp_eager(qp, cfg.solver)),
                  "wbc.solve": replay_ms(
                      lambda: wbc._solve_eager(cfg, wst, ref)),
                  "physics (disturbance, physics.step)": replay_ms(phys),
                  "margin, observer and trace": replay_ms(tail),
                  "tick": replay_ms(lambda: loop._step(
                      cfg, cyc, carry, k, loop._trace_buffers(
                          sim0.q.shape[0], 1, sim0.q.dtype, dev)))}
        ms["torque map (wbc.solve - build - QP)"] = (
            ms["wbc.solve"] - ms["WBC build"] - ms["QP (solve_qp)"])
        parts = [key for key in ms if key not in ("wbc.solve", "tick")]
        total = sum(ms[key] for key in parts)
        print(f"[graph] {card}: the graphed tick's device time by stage, "
              f"B={Bn} (each stage captured alone, CUDA events over 50 "
              f"replays): " + "; ".join(
                  f"{key} {ms[key]:.4f} ms ({100 * ms[key] / total:.1f}%)"
                  for key in parts)
              + f"; sum {total:.4f} ms, the whole tick captured alone "
              f"{ms['tick']:.4f} ms, the cycle's graph {dev_ms:.4f} ms",
              flush=True)


class eager_plans(eager_wbc):
    """Within this block planner.plan and the cycle's head and tail run
    their eager bodies on the card (planner._plan_eager,
    loop._cycle_head_eager, loop._cycle_tail_eager), the graphs' plain
    versions, for comparison, and so do wbc.solve and solve_qp
    (eager_wbc)."""

    def __enter__(self):
        from apf_quadruped_tpu_torch import planner
        from apf_quadruped_tpu_torch.runtime import loop
        super().__enter__()
        self.real = planner.plan, loop._cycle_head, loop._cycle_tail
        planner.plan = planner._plan_eager
        loop._cycle_head = loop._cycle_head_eager
        loop._cycle_tail = loop._cycle_tail_eager

    def __exit__(self, *exc):
        from apf_quadruped_tpu_torch import planner
        from apf_quadruped_tpu_torch.runtime import loop
        planner.plan, loop._cycle_head, loop._cycle_tail = self.real
        super().__exit__(*exc)


def percentile(xs, q):
    return float(np.percentile(xs, q))


def same_bits(a, b):
    """Every tensor leaf of two trees equal in dtype, shape and bits (NaN
    included)."""
    import torch

    from apf_quadruped_tpu_torch.runtime import graph

    la, lb = graph._tensors(a), graph._tensors(b)
    if len(la) != len(lb):
        return False
    for x, y in zip(la, lb):
        if x.dtype != y.dtype or x.shape != y.shape:
            return False
        if x.is_floating_point():
            bits = {2: torch.int16, 4: torch.int32, 8: torch.int64}
            x = x.view(bits[x.element_size()])
            y = y.view(bits[y.element_size()])
        if not torch.equal(x, y):
            return False
    return True


def graphed_plan(dev, card):
    """Phase 21: planner.plan and the cycle's head replayed from captured
    CUDA graphs (runtime/graph.call) against their eager bodies
    (planner._plan_eager, loop._cycle_head_eager).  Bit for bit, at
    bench.py's problem B=2048, H=20 (the condensed backend at B=256):
    every backend and option cold and warm, a second problem through the
    two cached graphs, a NaN lane; sweep.run_batch at B=64, two 20-tick
    cycles, the graphed head and tail against the eager head, plan and
    tail.  Then, in
    turns with the eager plan: solves/s at B=2048 for "auto" and
    "riccati_fused"; replan latency p50/p99 at B=1 and B=64 (warm replans,
    each fenced by torch.cuda.synchronize()), the host's enqueue time and
    the graph's device time beside it; each graph's capture time and
    pool; the cycle's head and tail, graphed and eager, at the CLI's
    sweep configuration, B=64 and B=1024; and phase 3's production-shape
    parity counts beside them."""
    import dataclasses

    import torch

    from apf_quadruped_tpu_torch import planner, problems
    from apf_quadruped_tpu_torch.config import (EngineConfig, MpcConfig,
                                                SolverConfig)
    from apf_quadruped_tpu_torch.ops import riccati
    from apf_quadruped_tpu_torch.runtime import graph, loop, sweep
    from apf_quadruped_tpu_torch.sim import terrain

    def cfg_of(backend, H=20, mpc=None, solver=None):
        return EngineConfig(mpc=MpcConfig(horizon=H, dt=0.025,
                                          backend=backend, **(mpc or {})),
                            solver=SolverConfig(**(solver or {})))

    def problem(cfg, B, seed, cone=False):
        x0, refs = problems.bench_problem(cfg, B, seed=seed, device=dev)
        if cone:
            gen = torch.Generator(dev).manual_seed(seed)
            n = torch.randn(B, cfg.mpc.horizon, 4, 3, device=dev,
                            generator=gen) * 0.2
            n[..., 2] = 1.0
            refs = refs._replace(cone_rot=terrain.basis_from_normal(
                n / torch.linalg.vector_norm(n, dim=-1, keepdim=True)))
        return x0, refs

    def warm_of(out, B, H):
        return riccati.WarmStart(
            u=out.forces.reshape(B, H, 12), z=out.sol.z.reshape(B, H, -1),
            s=out.sol.s.reshape(B, H, -1),
            valid=torch.arange(B, device=dev) % 2 == 0)

    # ---- (a) graphed against eager, bit for bit ---------------------------
    t0 = time.perf_counter()
    cases = {
        "auto": ("auto", 2048, {}, {}, False),
        "auto cone_rot": ("auto", 2048, {}, {}, True),
        "auto stage_bf16": ("auto", 2048, {}, dict(stage_bf16=True), False),
        "auto sqp_iters=2": ("auto", 2048, dict(sqp_iters=2), {}, False),
        "auto base_box+base_acc": ("auto", 2048, dict(base_box=True,
                                                      base_acc=True), {},
                                   False),
        "riccati_fused": ("riccati_fused", 2048, {}, {}, False),
        "riccati_fused cone_rot": ("riccati_fused", 2048, {}, {}, True),
        "riccati_fused stage_bf16": ("riccati_fused", 2048, {},
                                     dict(stage_bf16=True), False),
        "riccati (the scan)": ("riccati", 2048, {}, {}, False),
        "use_pallas": ("riccati", 2048, {}, dict(use_pallas=True), False),
        "condensed (B=256)": ("condensed", 256, {}, {}, False),
    }
    same = {}
    for name, (backend, B, mpc, solver, cone) in cases.items():
        cfg = cfg_of(backend, mpc=mpc, solver=solver)
        graph.clear()
        ok = True
        for seed in (0, 1):       # the second problem replays both graphs
            x0, refs = problem(cfg, B, seed, cone)
            cold = planner.plan(cfg, x0, refs)
            ok &= same_bits(cold, planner._plan_eager(cfg, x0, refs))
            warm = warm_of(cold, B, cfg.mpc.horizon)
            ok &= same_bits(planner.plan(cfg, x0, refs, warm),
                          planner._plan_eager(cfg, x0, refs, warm))
            ok &= len(graph.entries()) == 2 - (backend == "condensed")
        same[name] = ok
    cfg = cfg_of("auto")
    x0, refs = problem(cfg, 2048, 0)
    graph.clear()
    planner.plan(cfg, x0, refs)
    x0n = x0.clone()
    x0n[1, 0] = float("nan")
    out = planner.plan(cfg, x0n, refs)
    same["a NaN lane through the cached graph, quarantined"] = (
        len(graph.entries()) == 1 and same_bits(out, planner._plan_eager(
            cfg, x0n, refs))
        and not bool(out.sol.converged[1])
        and bool((out.forces[1] == 0).all())
        and bool(torch.isfinite(out.forces).all()))
    c20 = sweep.cli_config()
    c20 = c20.replace(gait=dataclasses.replace(c20.gait, trot_cycle=0.05))
    scn = sweep.random_scenarios(c20, 64, seed=5, device=dev)
    graph.clear()
    graphed = sweep.run_batch(c20, scn, 2)
    calls = [e for e in graph.entries() if e.k is None]    # head, tail
    with eager_plans():
        eager = sweep.run_batch(c20, scn, 2)
    same["sweep.run_batch B=64, 2 cycles, graphed head and tail against "
         "eager"] = (len(calls) == 2 and len(tick_graphs()) == 1
                     and same_bits(graphed, eager))
    print(f"[plan graph] graphed plan and head against their eager bodies, "
          f"every output bit for bit (B=2048, H=20, cold and warm, a second "
          f"problem through the cached graphs): {json.dumps(same)} "
          f"({time.perf_counter() - t0:.1f} s)", flush=True)
    check(all(same.values()), "the graphed plan and head equal the eager "
          "ones bit for bit")

    # ---- (b) solves/s at B=2048, in turns ---------------------------------
    B, H = 2048, 20
    for backend, reps in (("auto", 20), ("riccati_fused", 10)):
        cfg = cfg_of(backend)
        x0, refs = problem(cfg, B, 0)
        graph.clear()
        planner.plan(cfg, x0, refs)
        planner._plan_eager(cfg, x0, refs)
        (entry,) = graph.entries()
        fns = {"eager": lambda: planner._plan_eager(cfg, x0, refs),
               "graphed": lambda: planner.plan(cfg, x0, refs)}
        rates = {"eager": [], "graphed": []}
        for _ in range(3):
            for label in ("eager", "graphed", "graphed", "eager"):
                torch.cuda.synchronize()
                t = time.perf_counter()
                for _ in range(reps):
                    out = fns[label]()
                torch.cuda.synchronize()
                rates[label].append(B * reps / (time.perf_counter() - t))
        dev_ms = event_ms(entry.graph.replay, reps=20)
        print(f"[plan graph] {card}: plan solves/s B={B} H={H} cold, backend "
              f"{backend!r}, in turns (eager, graphed, graphed, eager; 3 "
              f"rounds of {reps}-plan bursts): graphed "
              f"{median(rates['graphed']):.1f} "
              f"{[round(r, 1) for r in rates['graphed']]}, eager "
              f"{median(rates['eager']):.1f} "
              f"{[round(r, 1) for r in rates['eager']]}, "
              f"{median(rates['graphed']) / median(rates['eager']):.2f}x; "
              f"converged {float(out.sol.converged.float().mean()):.4f}; the "
              f"graph's device time {dev_ms:.4f} ms a plan (CUDA events, 20 "
              f"back-to-back replays), {B / dev_ms * 1e3:.1f} solves/s at "
              f"it", flush=True)

    # ---- (c) replan latency at B=1 and B=64, in turns ---------------------
    cfg = cfg_of("auto")
    for B in (1, 64):
        x0, refs = problem(cfg, B, 0)
        warm = warm_of(planner._plan_eager(cfg, x0, refs), B, H)
        warm = warm._replace(valid=torch.ones_like(warm.valid))
        x1, refs1 = problem(cfg, B, 1)
        graph.clear()
        planner.plan(cfg, x1, refs1, warm)
        planner._plan_eager(cfg, x1, refs1, warm)
        (entry,) = graph.entries()
        fns = {"eager": lambda: planner._plan_eager(cfg, x1, refs1, warm),
               "graphed": lambda: planner.plan(cfg, x1, refs1, warm)}
        lat = {"eager": [], "graphed": []}
        enqueue = {"eager": [], "graphed": []}
        for _ in range(3):
            for label in ("eager", "graphed", "graphed", "eager"):
                for _ in range(100):
                    torch.cuda.synchronize()
                    t = time.perf_counter()
                    fns[label]()
                    t1 = time.perf_counter()
                    torch.cuda.synchronize()
                    lat[label].append(1e3 * (time.perf_counter() - t))
                    enqueue[label].append(1e3 * (t1 - t))
        dev_ms = event_ms(entry.graph.replay, reps=50)
        line = "; ".join(
            f"{label} p50 {percentile(lat[label], 50):.4f} ms, p99 "
            f"{percentile(lat[label], 99):.4f} ms (max "
            f"{max(lat[label]):.4f}), the host's enqueue time p50 "
            f"{percentile(enqueue[label], 50):.4f} ms"
            for label in ("graphed", "eager"))
        print(f"[plan graph] {card}: replan latency B={B} H={H} (warm, "
              f"backend 'auto', each plan fenced by torch.cuda.synchronize(), "
              f"{len(lat['graphed'])} plans a side in turns): {line}; the "
              f"graph's device time {dev_ms:.4f} ms (CUDA events, 50 "
              f"back-to-back replays)", flush=True)
        check(percentile(lat["graphed"], 50) < percentile(lat["eager"], 50),
              f"B={B}: the graphed replan is faster than the eager one")

    # ---- (d) the cycle outside its ticks -----------------------------------
    cfg = sweep.cli_config()
    for Bn in (64, 1024):
        scn = sweep.random_scenarios(cfg, Bn, seed=0, device=dev)
        st = sweep.init_batch(cfg, scn)
        terr = sweep._terrain(cfg, scn)
        args = (st, terr, scn.target_xy, scn.dist_sched)
        graph.clear()
        # a first 20-tick cycle: the state of a replan with a warm start,
        # and the tail's inputs
        seen = {}

        def spy(*a):
            seen["carry"], seen["trace"] = real_scan(*a)
            return seen["carry"], seen["trace"]

        real_scan = loop._scan_ticks
        loop._scan_ticks = spy
        try:
            st1, _ = loop.run_cycle(c20, *args)
        finally:
            loop._scan_ticks = real_scan
        args = (st1,) + args[1:]

        def head_eager():
            with eager_plans():
                return loop._cycle_head_eager(cfg, *args)

        head = loop._cycle_head(cfg, *args)
        check(same_bits(head, head_eager()), f"B={Bn}: the head's graph")
        # the tail on the first cycle's 20 ticks of trace
        tail_in = (head.tail, seen["carry"], seen["trace"])

        def tail_eager():
            return loop._cycle_tail_eager(cfg, *tail_in)

        def tail_graphed():
            return loop._cycle_tail(cfg, *tail_in)

        check(same_bits(tail_graphed(), tail_eager()),
              f"B={Bn}: the tail's graph equals the eager tail")
        fns = {"head eager": head_eager,
               "head graphed": lambda: loop._cycle_head(cfg, *args),
               "tail eager": tail_eager, "tail graphed": tail_graphed}
        times = {k: [] for k in fns}
        for _ in range(5):
            for label in ("head eager", "head graphed", "tail eager",
                          "tail graphed", "tail graphed", "tail eager",
                          "head graphed", "head eager"):
                torch.cuda.synchronize()
                t = time.perf_counter()
                fns[label]()
                torch.cuda.synchronize()
                times[label].append(1e3 * (time.perf_counter() - t))
        med = {k: median(v) for k, v in times.items()}
        print(f"[plan graph] {card}: the cycle outside its ticks, B={Bn} at "
              f"the CLI's sweep configuration (host clock, each fenced by "
              f"torch.cuda.synchronize(), 10 a side in turns): the head "
              f"graphed {med['head graphed']:.4f} ms "
              f"{[round(v, 3) for v in times['head graphed']]}, eager (its "
              f"plan eager too) {med['head eager']:.4f} ms "
              f"{[round(v, 3) for v in times['head eager']]}; the tail "
              f"graphed {med['tail graphed']:.4f} ms, eager "
              f"{med['tail eager']:.4f} ms; outside the ticks: "
              f"{med['head graphed'] + med['tail graphed']:.4f} ms graphed, "
              f"{med['head eager'] + med['tail eager']:.4f} ms eager",
              flush=True)
        graph.clear()

    # ---- (e) phase 3's production-shape parity counts ----------------------
    prod = [p for p in PARITY if p[0].startswith("B=2048 H=20")]
    print("[plan graph] phase 3's production-shape parity (the resident "
          "kernel against the plain scan, B=2048, H=20): " + ("; ".join(
              f"{tag}: iters differ on {bad}/{n} lanes, {far} lanes beyond "
              f"{atol:g} (max {err:.3g})"
              for tag, bad, n, far, err, atol in prod)
              or "not run (phase 3 did not run)"), flush=True)


def wbc_latency(dev, card):
    """Phase 22: wbc.solve and solve_qp replayed from captured CUDA graphs
    (runtime/graph.call) against their eager bodies (wbc._solve_eager,
    qpsolve._solve_qp_eager), and the WBC tick latency against the
    reference's 400 Hz budget (2.5 ms a tick), measured as the JAX
    package's benchmarks/wbc_latency.py measures it, on its states
    (problems.wbc_problem, seed 0) at EngineConfig() with SolverConfig()
    in float32.  (a) bit for bit at B in {1, 64, 128, 1024}, each graph
    captured on one draw and replayed on another, a NaN lane at B=64
    through the cached graph, and the launch counters against an eager
    call's; (b) the wall latency of a call, each fenced by
    torch.cuda.synchronize(), graphed and eager in turns (600 graphed and
    150 eager calls at B=1, 200 and 50 at B=64, 128, 1024), with the
    host's enqueue time, the graph's device time by CUDA events, its
    capture and pool; (c) the
    marginal cost of a solve in a tick scan: graph.scan of K solves at B=1
    (tick k at q0 + dq[k]), 20 calls of each K in {64, 256}, fit
    t(K) = a + b K.  Reports the budget, does not gate on it."""
    import torch

    from apf_quadruped_tpu_torch import problems, wbc
    from apf_quadruped_tpu_torch.config import EngineConfig, SolverConfig
    from apf_quadruped_tpu_torch.models import rbd
    from apf_quadruped_tpu_torch.ops import cuda_chol, cuda_qp, qpsolve
    from apf_quadruped_tpu_torch.runtime import graph
    from apf_quadruped_tpu_torch.sim import physics

    cfg = EngineConfig(solver=SolverConfig())
    budget_ms = 2.5
    batches = (1, 64, 128, 1024)

    def wbc_entry(B):
        """The cached graph of wbc.solve at batch B."""
        return [e for e in graph.entries()
                if isinstance(e.outs, wbc.WbcOutput)
                and e.outs.tau.shape[0] == B][0]

    # ---- (a) graphed against eager, bit for bit ---------------------------
    t0 = time.perf_counter()
    graph.clear()
    same, probs = {}, {}
    for B in batches:
        ok = True
        for seed in (0, 1):     # the second draw replays the cached graphs
            st, ref = problems.wbc_problem(cfg, B, seed=seed, device=dev)
            ok &= same_bits(wbc.solve(cfg, st, ref),
                            wbc._solve_eager(cfg, st, ref))
            qp, _ = wbc._build_qp(cfg, st, ref)
            ok &= same_bits(qpsolve.solve_qp(qp, cfg.solver),
                            qpsolve._solve_qp_eager(qp, cfg.solver))
        probs[B] = (st, ref)
        same[f"B={B}"] = ok
    n_graphs = len(graph.entries())
    st, ref = probs[64]
    q = st.q.clone()
    q[1, 0] = float("nan")
    bad = st._replace(q=q)
    out = wbc.solve(cfg, bad, ref)
    same["a NaN lane at B=64 through the cached graph, quarantined"] = (
        len(graph.entries()) == n_graphs
        and same_bits(out, wbc._solve_eager(cfg, bad, ref))
        and not bool(out.sol.converged[1])
        and bool((out.sol.x[1] == 0).all())
        and bool(torch.isfinite(out.sol.x).all())
        and bool(torch.isfinite(torch.cat([out.tau[:1], out.tau[2:]])).all()))
    counters = (cuda_chol.chol_factor, cuda_chol.chol_sub,
                cuda_qp.solve_qp_resident)

    def counts():
        return tuple(f.launches for f in counters)

    def entry_counts(entry):
        return tuple(entry.launches[graph._counters().index(f)]
                     for f in counters)

    n0 = counts()
    wbc._solve_eager(cfg, st, ref)
    eager_n = tuple(b - a for a, b in zip(n0, counts()))
    replays = []
    for _ in range(3):
        n0 = counts()
        wbc.solve(cfg, st, ref)
        replays.append(tuple(b - a for a, b in zip(n0, counts())))
    same["counters: a replay adds an eager call's launches, one resident "
         "QP launch and no SPD launch"] = (
        all(r == eager_n for r in replays) and eager_n == (0, 0, 1)
        and entry_counts(wbc_entry(64)) == eager_n)
    print(f"[wbc graph] graphed wbc.solve and solve_qp against their eager "
          f"bodies, every output bit for bit (EngineConfig(), "
          f"SolverConfig(), float32, problems.wbc_problem; captured on one "
          f"draw, replayed on another): {json.dumps(same)}; {n_graphs} "
          f"graphs cached; an eager call launches {eager_n[0]} SPD factors, "
          f"{eager_n[1]} substitutions and {eager_n[2]} resident QP "
          f"kernels, a replay adds {replays[0]} "
          f"({time.perf_counter() - t0:.1f} s)", flush=True)
    check(all(same.values()), "the graphed wbc.solve and solve_qp equal "
          "their eager bodies bit for bit")

    # ---- (b) wall latency a call, graphed and eager in turns ---------------
    for B in batches:
        st, ref = probs[B]
        entry = wbc_entry(B)
        fns = {"eager": lambda: wbc._solve_eager(cfg, st, ref),
               "graphed": lambda: wbc.solve(cfg, st, ref)}
        lat = {"eager": [], "graphed": []}
        enqueue = {"eager": [], "graphed": []}
        # the eager side's blocks are a quarter of the graphed side's: its
        # call launches the build's ~785 kernels one by one, and the
        # graphed p99 is what the phase reports
        rounds = 3 if B == 1 else 1
        block = {"eager": 25, "graphed": 100}
        for _ in range(rounds):
            for label in ("eager", "graphed", "graphed", "eager"):
                for _ in range(block[label]):
                    torch.cuda.synchronize()
                    t = time.perf_counter()
                    out = fns[label]()
                    t1 = time.perf_counter()
                    torch.cuda.synchronize()
                    lat[label].append(1e3 * (time.perf_counter() - t))
                    enqueue[label].append(1e3 * (t1 - t))
        dev_ms = event_ms(entry.graph.replay, reps=50)
        conv = float(out.sol.converged.float().mean())
        stats = {k: (percentile(v, 50), percentile(v, 99), float(np.mean(v)))
                 for k, v in lat.items()}
        check(all(np.isfinite(x) for v in stats.values() for x in v)
              and np.isfinite(dev_ms), f"B={B}: finite times")

        def side(label):
            p50, p99, mean = stats[label]
            return (f"{label} p50 {p50:.4f} ms, p99 {p99:.4f} ms, mean "
                    f"{mean:.4f} ms (max {max(lat[label]):.4f}), "
                    f"{B / mean * 1e3:.1f} solves/s, the host's enqueue time "
                    f"p50 {percentile(enqueue[label], 50):.4f} ms")

        line = f"{side('graphed')}; {side('eager')}"
        budget = (f"; graphed p99 / the 2.5 ms budget (400 Hz): "
                  f"{stats['graphed'][1] / budget_ms:.3f}x"
                  if B == 1 else "")
        print(f"[wbc latency] {card}: WBC tick latency B={B} (wbc.solve, "
              f"each call fenced by torch.cuda.synchronize(), "
              f"{len(lat['graphed'])} graphed and {len(lat['eager'])} eager "
              f"calls in turns: eager, graphed, graphed, eager): {line}; "
              f"converged {conv:.4f}; the graph's device time "
              f"{dev_ms:.4f} ms (CUDA events, 50 back-to-back "
              f"replays){budget}", flush=True)

    # ---- (c) the marginal cost of a solve in a tick scan ------------------
    st0 = physics.initial_state(cfg, batch=(1,), device=dev)
    chain_st = wbc.WbcState(
        p_base=st0.p_base, R_wb=st0.R_wb, q=st0.q,
        u=torch.zeros(1, 18, device=dev),
        contact=torch.ones(1, 4, device=dev),
        crawl=torch.zeros(1, dtype=torch.bool, device=dev))
    z3, z43 = torch.zeros(1, 3, device=dev), torch.zeros(1, 4, 3, device=dev)
    chain_ref = wbc.WbcRefs(
        com_pos=rbd.com_position(cfg.robot, st0.p_base, st0.R_wb, st0.q),
        com_vel=z3, com_acc=z3, rpy=z3, omega=z3, omega_dot=z3,
        swing_pos=z43, swing_vel=z43, swing_acc=z43)
    rng = np.random.default_rng(0)

    def step(inputs, carry, k, outs):
        dq, st_, ref_ = inputs
        out = wbc.solve(cfg, st_._replace(q=st_.q + dq.index_select(0, k)),
                        ref_)
        outs[0].index_copy_(1, k, out.sol.converged.float().unsqueeze(1))
        return (carry[0] + out.tau,)

    def chain(K):
        dq = torch.as_tensor(rng.normal(size=(K, 12)) * 0.01,
                             dtype=torch.float32, device=dev)
        conv = torch.zeros(1, K, device=dev)

        def run():
            acc = graph.scan(("wbc chain", cfg), step, (dq, chain_st,
                                                        chain_ref),
                             (torch.zeros(1, 12, device=dev),), (conv,), K)
            torch.cuda.synchronize()
            return acc

        acc = run()                                   # the capture
        ts = []
        for _ in range(20):
            t = time.perf_counter()
            acc = run()
            ts.append(time.perf_counter() - t)
        check(bool(torch.isfinite(acc[0]).all()), f"K={K}: finite torques")
        return np.asarray(ts), float(conv.mean())

    graph.clear()
    t64, _ = chain(64)
    t256, conv_c = chain(256)
    marg = (t256 - t64.mean()) / (256 - 64)
    marg_ms, marg_p99 = float(marg.mean() * 1e3), percentile(marg * 1e3, 99)
    check(np.isfinite(marg_ms) and np.isfinite(marg_p99),
          "finite marginal times")
    print(f"[wbc latency] {card}: the marginal WBC solve in a tick scan, "
          f"B=1 (graph.scan of K wbc.solve ticks, tick k at q0 + dq[k]; 20 "
          f"calls of each K, each fenced by torch.cuda.synchronize(); "
          f"t(K) = a + b K over K = 64, 256): b mean {marg_ms:.4f} ms, p99 "
          f"{marg_p99:.4f} ms; b p99 / the 2.5 ms budget "
          f"{marg_p99 / budget_ms:.3f}x; a "
          f"{1e3 * t64.mean() - 64 * marg_ms:.4f} ms; t(64) mean "
          f"{1e3 * t64.mean():.3f} ms, t(256) mean "
          f"{1e3 * t256.mean():.3f} ms; converged {conv_c:.4f}", flush=True)
    graph.clear()


def take_lanes(tree, lanes):
    """A NamedTuple tree of (B, ...) tensors at the batch rows `lanes`."""
    return type(tree)(*(take_lanes(v, lanes) if hasattr(v, "_fields")
                        else None if v is None else v[lanes] for v in tree))


def golden_cycle(g, case, k, st, m, cfg, twin_flips, lanes=None,
                 ticks=None):
    """Hold cycle k of `case` (LoopState `st`, CycleMetrics `m`) to a
    closed-loop golden's float32 run with golden_gate, as phases 23 and 24
    do (phase 24 with `lanes`, the lanes held, and golden_gate's `ticks`),
    but two kinds of leaf: the flags and counts that the JAX float64
    run itself flips when its start's joint angles move by 1e-12 rad (the
    golden's "f64p"; they must be twin_flips[(case, k)]), and fake_crawl
    (rob_mean < ApfConfig.crawl_threshold) in a lane whose JAX float32
    rob_mean lies within rob_mean's gate of the threshold, where rounding
    decides it (the lanes away from it held exactly).  Returns (the worst
    (diff / gate, leaf), the flipped leaves "c<k>.<leaf>", the left-out
    lanes (cycle, lane, JAX f32 rob_mean, |it - threshold|, port rob_mean,
    it - threshold))."""
    from apf_quadruped_tpu_torch import convert

    head = f"{case}.c{k}."
    flips = {key[len("f64p." + head):] for key in g
             if key.startswith("f64p." + head)
             and g[key].dtype.kind in "bi"
             and not np.array_equal(g[key], g["f64" + key[4:]])}
    check(flips == twin_flips.get((case, k), set()),
          f"{case} cycle {k}: the flags the JAX float64 twin flips {flips}")
    skip = {f"f32.{head}{leaf}" for leaf in flips}
    if lanes is not None and not lanes:
        return (0.0, ""), sorted(f"c{k}.{leaf}" for leaf in flips), []
    if lanes is not None:
        g = {key: v[lanes] for key, v in g.items() if f".{head}" in key}
        st, m = take_lanes(st, lanes), take_lanes(m, lanes)
    # fake_crawl where rob_mean's gate spans the threshold
    rob32 = g[f"f32.{head}metrics.rob_mean"][:, 0].astype(float)
    rob64 = g[f"f64.{head}metrics.rob_mean"][:, 0]
    margin = np.abs(rob32 - cfg.apf.crawl_threshold)
    near = margin <= (5.0 * np.abs(rob32 - rob64).max()
                      + 1e-4 * (1.0 + np.abs(rob64).max()))
    rounded = []
    if near.any():
        key = f"f32.{head}metrics.fake_crawl"
        skip.add(key)
        port = convert.to_numpy(m.fake_crawl)[:, 0]
        check(np.array_equal(port[~near], g[key][~near, 0]),
              f"{key} in the lanes away from the threshold")
        rob = convert.to_numpy(m.rob_mean)[:, 0].astype(float)
        rounded = [(f"c{k}", int(lane), float(rob32[lane]),
                    float(margin[lane]), float(rob[lane]),
                    float(rob[lane] - cfg.apf.crawl_threshold))
                   for lane in np.flatnonzero(near)]
    gw = golden_gate(g, head, {"state": st, "metrics": m}, skip, ticks)
    return ((gw[0], gw[1][len("f32."):]),
            sorted(f"c{k}.{leaf}" for leaf in flips), rounded)


# (case, cycle) of tests/data/mode_golden.npz -> the flag and count leaves
# that the JAX float64 run itself flips when its start's joint angles move
# by 1e-12 rad (the golden's "f64p"); tests/test_torch_loop_modes.py holds
# the CPU run to the same list and checks that the two agree
TWIN_FLIPS = {("adaptive", 1): {"metrics.mpc_iters"}}


def gait_modes(dev, card):
    """Phase 23: the closed loop in every gait mode of the command line and
    in replan cycles after the first, against the JAX package's float32
    runs (tests/data/mode_golden.npz, written by
    tests/data/make_mode_golden.py): trot 3 cycles (the mirrored warm
    start of pair B), crawl 1 (H=40), pace 2 (a fixed stride) and adaptive
    2 (the in-loop trot <-> crawl switch), at the CLI's sweep configuration
    per mode on the golden's B=2 scenarios, cycle by cycle through
    sweep.init_batch / step_batch as the golden was written: the graphed
    head, tick and tail, the resident IPM at H=20 and 40, the SPD kernels
    at n=30 and 18.  Every leaf of every cycle with golden_gate, but the
    flags and counts that the JAX float64 run itself flips when its start's
    joint angles move by 1e-12 rad (the golden's "f64p"; they must be
    TWIN_FLIPS), and fake_crawl (rob_mean < ApfConfig.crawl_threshold) in
    a lane whose JAX float32 rob_mean lies within rob_mean's gate of the
    threshold, where rounding decides it: named with JAX's and the port's
    rob_mean and their margins, and the lanes away from it held exactly.
    Per case the worst diff / gate and its leaf, the wall time and the
    launch counts: the resident IPM once a cycle, the SPD kernels every
    tick."""
    import torch

    from apf_quadruped_tpu_torch import convert
    from apf_quadruped_tpu_torch.runtime import sweep

    with np.load(ROOT / "tests" / "data" / "mode_golden.npz") as f:
        g = {k: f[k] for k in f.files}
    scn = convert.unflatten(g, "scn", sweep.Scenario, dev)
    scn = sweep.Scenario(*(None if v is None else v.to(torch.float32)
                          for v in scn))
    cycles = {}
    for key in g:
        hit = re.match(r"f32\.(\w+)\.c(\d+)\.", key)
        if hit:
            cycles[hit[1]] = max(cycles.get(hit[1], 0), int(hit[2]) + 1)
    check(list(cycles) == ["trot", "crawl", "pace", "adaptive"],
          f"the golden's cases {cycles}")
    t_all = time.perf_counter()
    for case, n in cycles.items():
        cfg = sweep.cli_config(gait=case)
        zero_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        st = sweep.init_batch(cfg, scn)
        worst, flipped, rounded = (0.0, ""), [], []
        for k in range(n):
            st, m = sweep.step_batch(cfg, scn, st, 1)
            gw, flips, near = golden_cycle(g, case, k, st, m, cfg,
                                           TWIN_FLIPS)
            worst, flipped, rounded = (max(worst, gw), flipped + flips,
                                       rounded + near)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = read_launches()
        n_ticks = round(float(st.sim.t[0]) / (n * cfg.sim.dt))
        per_tick = {k: v / (n * n_ticks) for k, v in launches.items()}
        print(f"[modes] {card}: {case}, B={scn.target_xy.shape[0]}, {n} "
              f"cycles of {n_ticks} ticks in {wall:.1f} s "
              f"({1e3 * wall / (n * n_ticks):.2f} ms a tick), crawling in "
              f"the last cycle {m.crawling[:, 0].tolist()}, R22 "
              f"{st.sim.R_wb[:, 2, 2].tolist()}; vs JAX float32 golden: "
              f"every leaf within its gate, worst {worst[1]} at "
              f"{worst[0]:.3f} of its gate; left out (flipped by the JAX "
              f"float64 twin): {flipped or 'none'}; fake_crawl left out "
              f"(cycle, lane, JAX f32 rob_mean, |it - threshold|, port "
              f"rob_mean, it - threshold): {rounded or 'none'}; launches "
              f"{launches} ({per_tick} a tick)", flush=True)
        check(launches["resident_ipm"] == n,
              f"{case}: the resident IPM once a cycle")
        check(all(v > 0 for v in launches.values()),
              f"{case}: every kernel of the loop launched")
    print(f"[modes] phase 23 in {time.perf_counter() - t_all:.1f} s",
          flush=True)


# (case, cycle) of tests/data/switch_golden.npz, world_golden.npz and
# option_golden.npz (their case names differ) -> the flag and count leaves
# that the JAX float64 run itself flips when its start's joint angles move
# by 1e-12 rad; tests/test_torch_loop_switch.py, test_torch_loop_worlds.py
# and test_torch_loop_options.py hold the CPU run to the same lists, and a
# CPU test checks that they agree
TWIN_FLIPS_24 = {("switch", 1): {"metrics.mpc_iters"},
                 ("switch", 2): {"metrics.mpc_iters"},
                 ("qd_limit", 1): {"metrics.mpc_converged",
                                   "metrics.mpc_iters"}}
# a lane whose JAX float64 twins end a cycle farther apart than this in q
# (rad) is chaotic from that cycle on: a 1e-12 rad rounding has grown a
# billionfold.  The goldens' lanes lie either below 1.5e-4 or above 0.01
CHAOS_Q = 1e-3
# the least distance from its threshold of the rob_mean that decides a
# gait decision the card is held to in a chaotic lane
# (tests/data/make_switch_golden.py's MARGIN)
DECISION_MARGIN = 0.01


def option_config(g, case):
    """sweep.cli_config() with the one field that option_golden.npz names
    for `case` ("case.<case>.<section>.<field>", its value) changed."""
    from apf_quadruped_tpu_torch.runtime import sweep

    (key,) = [k for k in g if k.startswith(f"case.{case}.")]
    _, _, section, field = key.split(".")
    cfg = sweep.cli_config()
    return cfg.replace(**{section: dataclasses.replace(
        getattr(cfg, section), **{field: g[key].item()})})


def option_scenarios(g, case, device, dtype):
    """The scenarios option_golden.npz ran `case` on: the case's own
    ("scn_<case>.<field>") where it has them, else the shared ("scn.")."""
    from apf_quadruped_tpu_torch import convert
    from apf_quadruped_tpu_torch.runtime import sweep

    prefix = f"scn_{case}" if f"scn_{case}.target_xy" in g else "scn"
    scn = convert.unflatten(g, prefix, sweep.Scenario, device)
    return sweep.Scenario(*(None if v is None else v.to(dtype)
                           for v in scn))


def batch_cycles(cfg, scn, n, crawling=None):
    """n cycles of sweep.step_batch from sweep.init_batch (its crawling
    flags set to `crawling` if given): ([(LoopState before the cycle,
    after it, CycleMetrics)], one_cycle(cfg, st) -> a cycle from st)."""
    from apf_quadruped_tpu_torch.runtime import sweep

    def one_cycle(cfg, st):
        return sweep.step_batch(cfg, scn, st, 1)

    st = sweep.init_batch(cfg, scn)
    if crawling is not None:
        st = st._replace(crawling=crawling)
    out = []
    for _ in range(n):
        st2, m = one_cycle(cfg, st)
        out.append((st, st2, m))
        st = st2
    return out, one_cycle


def world_cycles(spawn, world, cfg, n, device, dtype=None):
    """The `run` command's closed loop (__main__.run_closed_loop) on the
    height world `world` for n cycles, loop.init given `spawn` as its `xy`
    and each cycle recorded from loop.run_cycle: ([(LoopState before the
    cycle, after it, CycleMetrics (1, 1, ...))], one_cycle(cfg, st) -> a
    cycle of that loop from st)."""
    from apf_quadruped_tpu_torch import __main__ as cli
    from apf_quadruped_tpu_torch.runtime import loop

    calls = []
    init, run_cycle = loop.init, loop.run_cycle

    def recorded(*args):
        out = run_cycle(*args)
        calls.append((args, out[0]))
        return out

    loop.init = lambda *a, **kw: init(*a, xy=tuple(spawn), **kw)
    loop.run_cycle = recorded
    try:
        st, m, terr, _ = cli.run_closed_loop(
            cfg, world=world, target="0,1.5", cycles=n, dtype=dtype,
            device=device)
    finally:
        loop.init, loop.run_cycle = init, run_cycle
    check(terr.h_map is not None and len(calls) == n and calls[-1][1] is st,
          f"{world}: a height world through run_closed_loop")
    inputs = calls[0][0][2:]      # the terrain, target and pushes

    def one_cycle(cfg, st):
        return loop.run_cycle(cfg, st, *inputs)

    return [(args[1], st2, loop.CycleMetrics(*(v[:, k:k + 1] for v in m)))
            for k, (args, st2) in enumerate(calls)], one_cycle


def held_decisions(g, case):
    """(cycle, lane) of an adaptive golden's gait decisions that no
    rounding decides: crawling at cycle k's head is the same in the JAX
    float64 run, its three twins and the float32 run, after the same
    decision at the head before, and the float32 run's rob_mean lies
    DECISION_MARGIN or more from the threshold that held it
    (ApfConfig.crawl_exit_threshold in a lane that was crawling, else
    crawl_enter_threshold).  The card's crawl decision and warm flag are
    held to JAX float32's there, in a chaotic lane too."""
    from apf_quadruped_tpu_torch.config import ApfConfig

    runs = ("f64", "f64p", "f64m", "f64b", "f32")
    apf = ApfConfig()
    before = {r: g["init.crawling"] for r in runs}
    held, k = [], 0
    while f"f32.{case}.c{k}.metrics.crawling" in g:
        now = {r: g[f"{r}.{case}.c{k}.metrics.crawling"][:, 0] for r in runs}
        rob = g[f"f32.{case}.c{k}.metrics.rob_mean"][:, 0].astype(float)
        thr = np.where(before["f32"], apf.crawl_exit_threshold,
                       apf.crawl_enter_threshold)
        for b in range(len(rob)):
            if (len({(bool(before[r][b]), bool(now[r][b]))
                     for r in runs}) == 1
                    and abs(rob[b] - thr[b]) >= DECISION_MARGIN):
                held.append((k, b))
        before, k = now, k + 1
    return held


def chaotic(g, case, k):
    """The lanes whose JAX float64 twins end cycle k of `case` more than
    CHAOS_Q apart in q, with that distance."""
    key = f"{case}.c{k}.state.sim.q"
    ref = g[f"f64.{key}"]
    spread = np.max([np.abs(g[f"{t}.{key}"] - ref).max(axis=-1)
                     for t in ("f64p", "f64m", "f64b")], axis=0)
    return [(int(b), float(spread[b]))
            for b in np.flatnonzero(spread > CHAOS_Q)]


def graphed_is_eager(one_cycle, cfg, st):
    """One 20-tick cycle (short_cycles) of `one_cycle` from LoopState st,
    graphed (head, plan, ticks, WBC solves and tail) and then eager
    (eager_plans and eager_ticks): whether every output leaf is equal
    bit for bit."""
    cfg = short_cycles(cfg)
    graphed = one_cycle(cfg, st)
    with eager_plans(), eager_ticks():
        eager = one_cycle(cfg, st)
    return same_bits(graphed, eager)


def switch_worlds_options(dev, card):
    """Phase 24: the closed loop where phase 23's golden does not reach,
    against the JAX package's float32 runs, cycle by cycle: (a) adaptive
    switching one lane into crawl while the other trots, and a lane
    leaving crawl (tests/data/switch_golden.npz: B=2, 3 cycles at H=40,
    the lanes differing in `crawling` and in their warm start's validity
    in cycle 2); (b) the `run` command's closed loop
    (__main__.run_closed_loop) on the slope and the stairs
    (world_golden.npz: B=1, 2 cycles, spawned on the golden's spawn with
    loop.init's `xy`): the cone bases and contact on a height map; (c) the
    CLI's sweep configuration with one opt-in option changed per case
    (option_golden.npz: B=2, 2 cycles each), the plan's state rows
    (base_box) and acceleration rows (base_acc) in the resident IPM among
    them.  Graphed head, tick and tail, every leaf with golden_gate and
    phase 23's rules (golden_cycle, TWIN_FLIPS_24), and two more: a share
    of the cycle's ticks may move by one tick (golden_gate's `ticks`), and
    a lane is left out from the cycle where its JAX float64 twins turn
    chaotic (CHAOS_Q): its float32 run is then one sample of a trajectory
    that a rounding decides.  Two witnesses that chaos cannot break stand
    in for what those lanes leave out: from each left-out cycle's head
    (and from every head of the switch), one 20-tick cycle graphed
    against eager, bit for bit; and the switch's crawl decisions and warm
    flags against JAX float32's wherever no rounding decides them
    (held_decisions), with a cycle whose lanes differ in `crawling` and
    in the validity of their warm start among the witnessed heads.  Per
    case the worst diff / gate and its leaf, the lanes left out, the
    witnesses, the wall time and ms a tick, the launches of the resident
    IPM and the SPD kernels, and the graphs captured and the bytes their
    pools hold."""
    import functools

    import torch

    from apf_quadruped_tpu_torch import apf, convert
    from apf_quadruped_tpu_torch.runtime import graph, loop, sweep

    def load(name):
        with np.load(ROOT / "tests" / "data" / f"{name}_golden.npz") as f:
            return {k: f[k] for k in f.files}

    def n_cycles(g, case):
        return 1 + max(int(hit[1]) for hit in (
            re.match(rf"f32\.{case}\.c(\d+)\.", key) for key in g) if hit)

    jobs = []       # (golden, case, cfg, run) with run() batch_cycles'
    g = load("switch")
    cfg = sweep.cli_config(gait="adaptive")
    scn = convert.unflatten(g, "scn", sweep.Scenario, dev)
    jobs.append((g, "switch", cfg, functools.partial(
        batch_cycles, cfg, sweep.Scenario(*(
            None if v is None else v.to(torch.float32) for v in scn)),
        n_cycles(g, "switch"),
        torch.as_tensor(g["init.crawling"], device=dev))))
    g = load("world")
    for world in ("slope", "stairs"):
        cfg = sweep.cli_config()
        jobs.append((g, world, cfg, functools.partial(
            world_cycles, g[f"spawn.{world}"].tolist(), world, cfg,
            n_cycles(g, world), dev)))
    g = load("option")
    cases = [k.split(".")[1] for k in g if k.startswith("case.")]
    check(len(cases) == 9, f"the option golden's cases {cases}")
    for case in cases:
        cfg = option_config(g, case)
        jobs.append((g, case, cfg, functools.partial(
            batch_cycles, cfg, option_scenarios(g, case, dev, torch.float32),
            n_cycles(g, case))))

    t_all = time.perf_counter()
    mixed = False
    for g, case, cfg, run in jobs:
        graph.clear()
        zero_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        cycles, one_cycle = run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = read_launches()
        captures = graph.entries()
        n = len(cycles)
        n_ticks = round(float(cycles[-1][1].sim.t[0]) / (n * cfg.sim.dt))
        worst, flipped, rounded = (0.0, ""), [], []
        held, left = list(range(cycles[0][1].sim.q.shape[0])), []
        for k, (_, st, m) in enumerate(cycles):
            left += [(f"c{k}", b, d) for b, d in chaotic(g, case, k)
                     if b in held]
            held = [b for b in held if b not in {x[1] for x in left}]
            gw, flips, near = golden_cycle(g, case, k, st, m, cfg,
                                           TWIN_FLIPS_24, held, n_ticks)
            worst, flipped, rounded = (max(worst, gw), flipped + flips,
                                       rounded + near)
        # the witnesses: graphed against eager from the left-out heads
        t1 = time.perf_counter()
        first = min([int(c[1:]) for c, _, _ in left], default=n)
        witnessed = range(0 if case == "switch" else first, n)
        same = {}
        for k in witnessed:
            st = cycles[k][0]
            same[f"c{k}"] = graphed_is_eager(one_cycle, cfg, st)
            flag, crawling, _ = loop._gait_schedule(
                cfg, st, apf.update_robustness(cfg.apf, st.apf))
            valid = st.warm_valid & (st.warm_flag == flag)
            mixed |= bool(crawling.any() and not crawling.all()
                          and valid.any() and not valid.all())
        check(all(same.values()), f"{case}: the left-out heads' 20-tick "
              f"cycles graphed against eager, bit for bit: {same}")
        decisions = held_decisions(g, case) if case == "switch" else []
        for k, b in decisions:
            st, m = cycles[k][1], cycles[k][2]
            for leaf, port in (("metrics.crawling", m.crawling[b, 0]),
                               ("state.crawling", st.crawling[b]),
                               ("state.warm_flag", st.warm_flag[b])):
                ref = np.ravel(g[f"f32.{case}.c{k}.{leaf}"][b])[0]
                check(np.array_equal(convert.to_numpy(port), ref),
                      f"{case} cycle {k} lane {b}: {leaf} against JAX "
                      f"float32's")
        rows = "".join(f", {name} rows" for name, on in (
            ("state", cfg.mpc.base_box), ("accel", cfg.mpc.base_acc)) if on)
        print(f"[switch/worlds/options] {card}: {case}, "
              f"B={st.sim.q.shape[0]}, {n} cycles of {n_ticks} ticks in "
              f"{wall:.1f} s "
              f"({1e3 * wall / (n * n_ticks):.2f} ms a tick), crawling "
              f"{[c.crawling[:, 0].tolist() for _, _, c in cycles]}, R22 "
              f"{cycles[-1][1].sim.R_wb[:, 2, 2].tolist()}; vs JAX float32 "
              f"golden: every leaf held within its gate, worst "
              f"{f'{worst[1]} at {worst[0]:.3f}' if worst[1] else 'none'} "
              f"of its gate; left out (flipped by the JAX "
              f"float64 twin): {flipped or 'none'}; fake_crawl left out "
              f"(cycle, lane, JAX f32 rob_mean, |it - threshold|, port "
              f"rob_mean, it - threshold): {rounded or 'none'}; lanes left "
              f"out from the cycle the JAX float64 run turns chaotic "
              f"(cycle, lane, its twins' distance in q): {left or 'none'}; "
              f"witnesses: 20-tick cycles from the heads "
              f"{list(same) or 'none'} graphed against eager, bit for bit "
              f"({time.perf_counter() - t1:.1f} s), gait decisions and warm "
              f"flags equal to JAX float32's at (cycle, lane) "
              f"{decisions or 'none'}; launches "
              f"{launches} (resident IPM at H={cfg.mpc.horizon}{rows}, "
              f"{cfg.mpc.sqp_iters} a cycle; SPD kernels at n=30 and 18); "
              f"{len(captures)} graphs captured", flush=True)
        check(launches["resident_ipm"] == n * cfg.mpc.sqp_iters,
              f"{case}: the resident IPM sqp_iters times a cycle")
        check(all(v > 0 for v in launches.values()),
              f"{case}: every kernel of the loop launched")
        if case == "switch":
            check(len(decisions) == 2 * n, f"switch: every gait decision "
                  f"held, {decisions}")
    check(mixed, "a witnessed head whose lanes differ in crawling and in "
          "the validity of their warm start")
    graph.clear()
    print(f"[switch/worlds/options] phase 24 in "
          f"{time.perf_counter() - t_all:.1f} s", flush=True)


def main():
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("torch.cuda.is_available() is False: the smoke "
                           "run needs a CUDA card")
    from apf_quadruped_tpu_torch import _kernels, convert, planner, problems
    from apf_quadruped_tpu_torch.config import (EngineConfig, MpcConfig,
                                                SolverConfig)
    from apf_quadruped_tpu_torch.ops import cuda_riccati, riccati

    t_start = time.perf_counter()
    dev = torch.device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    alone = {("--phase", "21"): graphed_plan,
             ("--phase", "22"): wbc_latency,
             ("--phase", "23"): gait_modes,
             ("--phase", "24"): switch_worlds_options}.get(
                 tuple(sys.argv[1:]))
    if sys.argv[1:] and not alone:
        raise SystemExit(f"usage: {sys.argv[0]} [--phase 21 | --phase 22 "
                         f"| --phase 23 | --phase 24]")

    # ---- 1. device ------------------------------------------------------
    print(f"[device] python {sys.version.split()[0]}, torch "
          f"{torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}; nvidia-smi: {card}", flush=True)

    # ---- 2. build (and 7: both libraries with nvcc at once) -------------
    def timed(load):
        t = time.perf_counter()
        load()
        return time.perf_counter() - t

    t0 = time.perf_counter()
    libs = ("resident_ipm", "spd_chol", "fused_riccati", "resident_qp")
    with ThreadPoolExecutor(len(libs)) as pool:
        builds = {name: pool.submit(timed, getattr(_kernels, name))
                  for name in libs}
        build_s = {name: f.result() for name, f in builds.items()}
    print(f"[build] {', '.join(libs)} built in parallel in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    print_ptxas(_kernels, "resident_ipm")
    if alone:
        alone(dev, card)
        print(card)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}))
        return

    # ---- 3. kernel vs plain on the card -------------------------------------
    cfg_t = SolverConfig(iters=15, reltol=1e-4, abstol=1e-4,
                         static_reg=1e-6, w_clip=1e6)
    rng = np.random.default_rng(0)
    max_err = 0.0

    def compare(q, cfg_s, warm_frac, tag, atol, min_frac):
        nonlocal max_err
        qp = convert.stage_qp(q, dev)
        warm = None
        if warm_frac:
            cold = riccati.solve_stage_qp(qp, cfg_s)
            valid = torch.rand(qp.x0.shape[0], device=dev,
                               generator=torch.Generator(dev).manual_seed(1))
            warm = riccati.WarmStart(u=cold.u, z=cold.z, s=cold.s,
                                     valid=valid < warm_frac)
        err = compare_solve(cuda_riccati.solve_stage_qp_resident, qp, cfg_s,
                            warm, tag, atol, min_frac)
        max_err = max(max_err, err)

    # B=4: the JAX suite's own 5e-5 gate; B=130: its lane-boundary test's
    # 1e-4 (tests/test_pallas_riccati.py), f32 rounding over more lanes;
    # both at the JAX suite's test solver config, on every lane.
    # Production shape: the production SolverConfig() and the JAX
    # package's 2e-4 production-shape gate, on 99.5% of lanes.  f32
    # summation order differs between kernel and plain version, so a lane
    # at the tolerance edge may flip its iteration, and a few
    # ill-conditioned lanes move more: on the warm state-row variant the
    # plain version's own f32 and f64 answers differ by up to 7e-4 on 2 of
    # 2048 lanes.  Every lane is bounded against the float64 solution.
    shapes = [(4, dict(H=5, NX=6, NU=4, M=6), cfg_t, 5e-5, 1.0),
              (130, dict(H=3, NX=4, NU=3, M=4), cfg_t, 1e-4, 1.0),
              (2048, dict(H=20, NX=13, NU=12, M=24), SolverConfig(), 2e-4,
               0.995)]
    for B, dims, cfg_s, atol, agree in shapes:
        for warm in (False, True):
            for mc in (0, 6):
                for acc in (False, True):
                    d = dict(dims, NX=13, NU=12, M=24) if acc else dims
                    q = problems.random_stage_qp(rng, B=B, mc=mc, acc=acc,
                                                 **d)
                    compare(q, cfg_s, 0.75 if warm else 0.0,
                            f"B={B} H={d['H']} nx={d['NX']} warm={warm} "
                            f"mc={mc} acc={acc}", atol, agree)

    # ---- 4. the JAX golden ----------------------------------------------------
    cfg = EngineConfig(mpc=MpcConfig(horizon=20, dt=0.025),
                       solver=SolverConfig())
    g = np.load(ROOT / "tests" / "data" / "plan_golden.npz")
    warm_g = convert.warm_start({"u": g["warm_u"], "z": g["warm_z"],
                                 "s": g["warm_s"], "valid": g["warm_valid"]},
                                dev)

    def golden(cfg_g, label=""):
        for tag, w in (("cold", None), ("warm", warm_g)):
            refs = convert.mpc_refs({k: g[f"{tag}_{k}"] for k in
                                     ("contacts", "feet_w", "x_ref",
                                      "yaw_ref")}, dev)
            out = planner.plan(cfg_g, convert.tensor(g[f"{tag}_x0"], dev),
                               refs, warm=w)
            f_ref = g[f"{tag}_forces"]
            df = float(np.abs(convert.to_numpy(out.forces) - f_ref).max())
            dxs = float(np.abs(convert.to_numpy(out.states)
                               - g[f"{tag}_states"]).max())
            ftol = 1e-3 * max(1.0, float(np.abs(f_ref).max()))
            print(f"[golden]{label} {tag}: iters "
                  f"{convert.to_numpy(out.sol.iters)} vs JAX "
                  f"{g[f'{tag}_iters']}, max|dforce| {df:.3g} (tol "
                  f"{ftol:.3g}), max|dstate| {dxs:.3g} (tol 1e-4)", flush=True)
            check(np.array_equal(convert.to_numpy(out.sol.converged),
                                 g[f"{tag}_converged"]),
                  f"golden{label} {tag} converged")
            check(np.array_equal(convert.to_numpy(out.sol.iters),
                                 g[f"{tag}_iters"]),
                  f"golden{label} {tag} iters")
            check(df <= ftol and dxs <= 1e-4,
                  f"golden{label} {tag} forces/states")

    golden(cfg)

    # ---- 5. the main path -----------------------------------------------------
    B, H = 2048, cfg.mpc.horizon
    check(planner.effective_backend(cfg, dev) == "riccati_resident",
          "auto resolves to the kernel on the card")
    x0, refs = problems.bench_problem(cfg, B, seed=0, device=dev)
    x1, refs1 = problems.bench_problem(cfg, B, seed=1, device=dev)
    cfg_box = EngineConfig(mpc=MpcConfig(horizon=20, dt=0.025, base_box=True,
                                         base_acc=True),
                           solver=SolverConfig())
    cuda_riccati.solve_stage_qp_resident.launches = 0
    cold = planner.plan(cfg, x0, refs)
    warm = riccati.WarmStart(u=cold.forces.reshape(B, H, 12),
                             z=cold.sol.z.reshape(B, H, -1),
                             s=cold.sol.s.reshape(B, H, -1),
                             valid=torch.ones(B, dtype=torch.bool, device=dev))
    replan = planner.plan(cfg, x1, refs1, warm=warm)
    boxed = planner.plan(cfg_box, x0, refs)
    torch.cuda.synchronize()
    launches = cuda_riccati.solve_stage_qp_resident.launches
    check(launches == 3, f"three plans launched the kernel {launches} times")
    for tag, p in (("cold", cold), ("warm replan", replan),
                   ("base_box+base_acc", boxed)):
        check(p.forces.shape == (B, H, 4, 3) and p.states.shape == (B, H, 13),
              f"{tag} shapes")
        check(bool(torch.isfinite(p.forces).all()), f"{tag} forces finite")
        conv = float(p.sol.converged.float().mean())
        print(f"[main] {tag}: converged {conv:.4f}, mean iters "
              f"{float(p.sol.iters.float().mean()):.3f}", flush=True)
        check(conv >= 0.99, f"{tag} converged on >= 99% of lanes")
    check(float(replan.sol.iters.float().mean())
          < float(cold.sol.iters.float().mean()), "warm start cuts iterations")
    # the same plans through the plain version, on the card
    cfg_plain = EngineConfig(mpc=MpcConfig(horizon=20, dt=0.025,
                                           backend="riccati"),
                             solver=SolverConfig())
    ref = planner.plan(cfg_plain, x0, refs)
    agree = ref.sol.iters == cold.sol.iters
    df = float((ref.forces - cold.forces).abs()[agree].max())
    ftol = 1e-3 * max(1.0, float(ref.forces.abs().max()))
    print(f"[main] cold plan vs plain plan: iters agree on "
          f"{float(agree.float().mean()):.4f} of lanes, max|dforce| {df:.3g} "
          f"(tol {ftol:.3g})", flush=True)
    check(float(agree.float().mean()) >= 0.995 and df <= ftol,
          "kernel plan agrees with the plain plan")

    # ---- 6. timing -------------------------------------------------------
    def plan_rate(c, reps):
        rates = []
        for _ in range(3):
            torch.cuda.synchronize()
            t = time.perf_counter()
            for _ in range(reps):
                out = planner.plan(c, x0, refs)
            torch.cuda.synchronize()
            rates.append(B * reps / (time.perf_counter() - t))
        return float(np.median(rates)), out

    def solve_ms(fn, qp, reps, solver=cfg.solver):
        fn(qp, solver)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn(qp, solver)
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / reps

    rate_k, out_k = plan_rate(cfg, 10)
    rate_p, _ = plan_rate(cfg_plain, 3)
    qp = planner.stage_qp(cfg, x0, refs)
    ms_k = solve_ms(cuda_riccati.solve_stage_qp_resident, qp, 10)
    ms_p = solve_ms(riccati.solve_stage_qp, qp, 3)
    print(f"[time] {card}: plan B={B} H={H} cold, converged "
          f"{float(out_k.sol.converged.float().mean()):.4f}: kernel "
          f"{rate_k:.1f} solves/s, plain {rate_p:.1f} solves/s (median of 3 "
          f"bursts)", flush=True)
    print(f"[time] {card}: stage-QP solve B={B} H={H}: kernel {ms_k:.3f} ms, "
          f"plain {ms_p:.3f} ms (CUDA events)", flush=True)
    # the kernel ends with its slowest warp: the iterations its lanes ran,
    # and its time when every lane runs all of them
    its_k = out_k.sol.iters.float()
    print(f"[time] {card}: iterations of the cold plan's lanes: min "
          f"{int(its_k.min())}, median {float(its_k.median()):.0f}, max "
          f"{int(its_k.max())} (mean {float(its_k.mean()):.3f})", flush=True)
    n_it = cfg.solver.iters
    ms_all = solve_ms(cuda_riccati.solve_stage_qp_resident, qp, 10,
                      SolverConfig(reltol=0.0, abstol=0.0))
    print(f"[time] {card}: stage-QP solve B={B} H={H}, reltol = abstol = 0 "
          f"(every lane runs {n_it} iterations): kernel {ms_all:.3f} ms, "
          f"{ms_all / n_it:.4f} ms an iteration (CUDA events)", flush=True)

    # the bound of this solve: this run's bytes, and the operations of
    # the iterations its lanes ran (a lane leaves the loop once converged:
    # `iters` full iterations and iters + 2 rollout/residual sweeps, one
    # fewer where it never converged)
    its = out_k.sol.iters.double()
    sweeps = its + 1.0 + out_k.sol.converged.double()
    nx, nu, m = 13, 12, 24
    f_roll, f_fac, f_vec = knot_flops(nx, nu, m)
    flops = H * float((its * (f_fac + 2 * f_vec) + sweeps * f_roll).sum())
    nbytes = 4 * B * (H * (nx * nx + nx * nu + nx + 2 * m)   # A, B, q, mask, h
                      + nx                                   # x0
                      + H * (nu + nx + 2 * m) + 4)           # u, x, z, s, stat
    b_res = bound(nbytes, flops)
    print(f"[bound] {card}: resident IPM B={B} H={H}: {flops / 1e9:.3f} "
          f"GFLOP over {float(its.sum()):.0f} lane-iterations, "
          f"{nbytes / 1e6:.1f} MB: bound {b_res[0]:.4f} ms ({b_res[1]}) "
          f"against {ms_k:.3f} ms, {100 * b_res[0] / ms_k:.2f}% of bound",
          flush=True)

    main_path, chol = closed_loop(dev, card, build_s["spd_chol"])
    fused = fused_slice(dev, card, build_s, golden, compare_solve, x0, refs,
                        x1, refs1, ref, rate_k)
    # the fused plan's kernels run every iteration: the device time of one
    # plan's launches of the three passes (phase 14), an iteration
    fused_ms = sum(r["ms"] * r["launches"] for r in fused
                   if r["name"].startswith("fused_"))
    print(f"[time] {card}: an IPM iteration at B={B} H={H}: resident kernel "
          f"{ms_all / n_it:.4f} ms (phase 6, every lane running {n_it}), "
          f"fused passes {fused_ms / n_it:.4f} ms ({fused_ms:.3f} ms of "
          f"device time a fused plan)", flush=True)

    def phase(n, fn, *args):
        t = time.perf_counter()
        out = fn(*args)
        now = time.perf_counter()
        print(f"[phases] phase {n} ({fn.__name__}) in {now - t:.1f} s, "
              f"{now - t_start:.1f} s since the start", flush=True)
        return out

    print(f"[phases] phases 1-14 in {time.perf_counter() - t_start:.1f} s",
          flush=True)
    phase(15, resumable_sweep, card, main_path)
    phase(16, zoo_robots, dev, card)
    phase(17, long_horizon, dev, card)
    phase(18, sharded_sweeps, dev, card)
    bf16 = phase(19, stage_bf16, dev, card, x0, refs, x1, refs1)
    phase(20, graphed_tick, dev, card, main_path)
    phase(21, graphed_plan, dev, card)
    phase(22, wbc_latency, dev, card)
    phase(23, gait_modes, dev, card)
    phase(24, switch_worlds_options, dev, card)

    print(json.dumps({"kernels": [{
        "name": "resident_ipm", "route": "cuda",
        "source": "apf_quadruped_tpu_torch/csrc/resident_ipm.cu",
        "replaces": "apf_quadruped_tpu/ops/pallas_riccati.py:551",
        "launches": launches, "max_abs_err": max_err, "ms": ms_k,
        "plain_ms": ms_p, "bound_ms": b_res[0], "bound_by": b_res[1],
        "library_ms": None}] + chol + fused + bf16}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
