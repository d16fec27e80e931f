#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port (apf_quadruped_tpu_torch) on one GPU.

    python3 chip_smoke.py          # from the repository root, one CUDA card

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
     the kernel's own time against the plain solve, at B=2048, H=20.
The last two lines are the kernels' JSON record and the device JSON line.
Uses no JAX: the card's machine has none.
"""

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"check failed: {msg}")


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

    dev = torch.device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]

    # ---- 1. device ------------------------------------------------------
    print(f"[device] python {sys.version.split()[0]}, torch "
          f"{torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}; nvidia-smi: {card}", flush=True)

    # ---- 2. build -------------------------------------------------------
    t0 = time.perf_counter()
    _kernels.resident_ipm()
    print(f"[build] resident_ipm built and loaded in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    for log in sorted(_kernels.BUILD_ROOT.glob("resident_ipm-*/build.log")):
        for line in log.read_text().splitlines():
            if "registers" in line or "stack frame" in line:
                print(f"[build] ptxas: {line.strip()}")

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
        ref = riccati.solve_stage_qp(qp, cfg_s, warm)
        out = cuda_riccati.solve_stage_qp_resident(qp, cfg_s, warm)
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
        max_err = max(max_err, float(err.max()))
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
    warm = convert.warm_start({"u": g["warm_u"], "z": g["warm_z"],
                               "s": g["warm_s"], "valid": g["warm_valid"]},
                              dev)
    for tag, w in (("cold", None), ("warm", warm)):
        refs = convert.mpc_refs({k: g[f"{tag}_{k}"] for k in
                                 ("contacts", "feet_w", "x_ref", "yaw_ref")},
                                dev)
        out = planner.plan(cfg, convert.tensor(g[f"{tag}_x0"], dev), refs,
                           warm=w)
        f_ref = g[f"{tag}_forces"]
        df = float(np.abs(convert.to_numpy(out.forces) - f_ref).max())
        dxs = float(np.abs(convert.to_numpy(out.states)
                           - g[f"{tag}_states"]).max())
        ftol = 1e-3 * max(1.0, float(np.abs(f_ref).max()))
        print(f"[golden] {tag}: iters {convert.to_numpy(out.sol.iters)} vs "
              f"JAX {g[f'{tag}_iters']}, max|dforce| {df:.3g} (tol "
              f"{ftol:.3g}), max|dstate| {dxs:.3g} (tol 1e-4)", flush=True)
        check(np.array_equal(convert.to_numpy(out.sol.converged),
                             g[f"{tag}_converged"]), f"golden {tag} converged")
        check(np.array_equal(convert.to_numpy(out.sol.iters),
                             g[f"{tag}_iters"]), f"golden {tag} iters")
        check(df <= ftol and dxs <= 1e-4, f"golden {tag} forces/states")

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

    def solve_ms(fn, qp, reps):
        fn(qp, cfg.solver)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn(qp, cfg.solver)
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

    print(json.dumps({"kernels": [{
        "name": "resident_ipm", "route": "cuda",
        "source": "apf_quadruped_tpu_torch/csrc/resident_ipm.cu",
        "replaces": "apf_quadruped_tpu/ops/pallas_riccati.py:551",
        "launches": launches, "max_abs_err": max_err, "ms": ms_k,
        "plain_ms": ms_p}]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
