#!/usr/bin/env python3
"""Where the resident IPM kernel's time goes, phase by phase, on the card.

    python3 ipm_phases.py                    # this checkout's kernel
    python3 ipm_phases.py --parent DIR       # and DIR's, e.g. an earlier
                                             # commit unpacked by git archive
    python3 ipm_phases.py --batch 132        # one scenario an SM: the
                                             # chain of one warp alone

`ncu` does not run on the card's machine, so this builds an instrumented
copy of a tree's csrc/resident_ipm.cu (into _checkout/phases/, gitignored):
lane 0 of each warp reads clock64() wherever the kernel passes from one
phase to the next and adds the cycles to that phase's total.  The phases:
  init    the cold or warm start (before the first iteration)
  load    waiting for a knot's records (the staged kernel: requesting
          the next knot's copies and waiting for this one's; the earlier
          kernel with synchronous loads: its reads of A_k, B_k, the masks
          and, in the corrector, L_k and K_k)
  rollout x_{k+1} = A x + B u (with the pending step on u)
  resid   costates and residuals (with the pending step on z, s)
  mbuild  barrier weights, B'P, A'P, B'PA and M_k
  chol    the Cholesky of M_k
  ksolve  K_k = M_k^-1 B'PA (and storing L_k)
  pupd    the P update and its symmetrization
  vector  the backward and forward vector passes
  muaff   mu_aff, sigma (and the earlier kernel's update pass: update)
Every tree is measured in a process of its own, on bench.py's problem at
H=20 and B=2048 (or --batch): the production SolverConfig() and reltol = abstol = 0 (every
lane runs all iterations).  Prints each phase's share of the warps' cycles
and the instrumented and plain kernels' CUDA-event times.  Needs one CUDA
card and nvcc; imports no JAX.
"""

import argparse
import ctypes
import hashlib
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent
PHASES = ("init", "load", "rollout", "resid", "mbuild", "chol", "ksolve",
          "pupd", "vector", "muaff", "update", "other")
NPH = len(PHASES)

# device-side counters and the macros that move a warp from phase to phase;
# slot NPH holds the last clock, NPH + 1 the current phase, NPH + 2 the
# phase a `load` interrupted
PRELUDE = """
__device__ unsigned long long ipm_ph_total[%(n)d + 1];
#define PH_LANE0 ((threadIdx.x & 31) == 0)
#define PH_DECL __shared__ long long ph_s_[WARPS][%(n)d + 3]; \\
  long long* ph_ = ph_s_[threadIdx.x >> 5]; \\
  if (PH_LANE0) { for (int i_ = 0; i_ < %(n)d; ++i_) ph_[i_] = 0; \\
    ph_[%(n)d] = clock64(); ph_[%(n)d + 1] = 0; }
#define PH(p) do { if (PH_LANE0) { const long long t_ = clock64(); \\
  ph_[ph_[%(n)d + 1]] += t_ - ph_[%(n)d]; ph_[%(n)d] = t_; \\
  ph_[%(n)d + 1] = (p); } } while (0)
#define PH_PUSH(p) do { if (PH_LANE0) ph_[%(n)d + 2] = ph_[%(n)d + 1]; \\
  PH(p); } while (0)
#define PH_POP PH(ph_[%(n)d + 2])
#define PH_FLUSH do { PH(%(other)d); if (PH_LANE0) { \\
  for (int i_ = 0; i_ < %(n)d; ++i_) \\
    atomicAdd(&ipm_ph_total[i_], (unsigned long long)ph_[i_]); \\
  atomicAdd(&ipm_ph_total[%(n)d], 1ull); } } while (0)
""" % {"n": NPH, "other": PHASES.index("other")}

EPILOGUE = """
extern "C" int resident_ipm_phases(unsigned long long* out, int reset) {
  int err = (int)cudaDeviceSynchronize();
  if (err) return err;
  err = (int)cudaMemcpyFromSymbol(out, ipm_ph_total,
                                  sizeof(unsigned long long) * (%(n)d + 1));
  if (err || !reset) return err;
  unsigned long long zero[%(n)d + 1] = {0};
  return (int)cudaMemcpyToSymbol(ipm_ph_total, zero, sizeof zero);
}
""" % {"n": NPH}


def ph(name):
    return f"PH({PHASES.index(name)});"


# (anchor, text put before it, text put after it) for each kernel version;
# every anchor must occur exactly once in its source
STAGED = [   # this PR's kernel: knots staged into a ring by cp.async
    ("  Work& W = *reinterpret_cast<Work*>(ring + 2 * SLOT);\n", "",
     "  PH_DECL\n"),
    ("      if (step + 1 < H) {\n", f"      PH_PUSH({PHASES.index('load')});\n",
     ""),
    ("      body(knot(step), ring + (step & 1) * SLOT);\n", "      PH_POP;\n",
     ""),
    ("    rollout(it > 0);\n", f"    {ph('rollout')}\n", ""),
    ("      float* scg = sc_k(k);\n      if (pend) {", f"      {ph('resid')}\n",
     ""),
    ("  auto factor_knot = [&](const float* S) {\n", "", f"    {ph('mbuild')}\n"),
    ("    // Cholesky of M, right-looking, lane i holding row i;",
     f"    {ph('chol')}\n", ""),
    ("    // K = M^-1 B'PbA, all 13 columns at once", f"    {ph('ksolve')}\n",
     ""),
    ("    // P <- sym(Q + A'Pb A - K' B'PbA)", f"    {ph('pupd')}\n", ""),
    ("                        auto rc, auto rcx, float* kff) {\n", "",
     f"    {ph('vector')}\n"),
    ("      const float* Kt = S + SL_SC + SC_KT;\n", f"      {ph('vector')}\n",
     ""),
    ("    }, [&](int, float* S) {\n", "", f"      {ph('muaff')}\n"),
    ("      return;\n    }\n    const float a_aff", "      PH_FLUSH;\n", ""),
]

SYNC = [     # the earlier kernel: synchronous knot loads
    ("  WarpSmem& S = smem[threadIdx.x / 32];\n", "", "  PH_DECL\n"),
    ("  auto load_knot = [&](int k) {\n    __syncwarp();\n", "",
     f"    PH_PUSH({PHASES.index('load')});\n"),
    ("    for (int r = lane; r < mt; r += 32) S.mrow[r] = r < m ? mg[r] : 1.f;\n"
     "    __syncwarp();\n", "", "    PH_POP;\n"),
    ("  auto measure = [&](float& mu, float& res) {\n", "",
     f"    {ph('rollout')}\n"),
    ("    float rx2 = 0.f, rz2 = 0.f, sz = 0.f;\n    if (lane < nx) S.lam[lane]",
     f"    {ph('resid')}\n", ""),
    ("      for (int r = lane; r < mt; r += 32)\n        S.w[r] = barrier_w(",
     f"      {ph('mbuild')}\n", ""),
    ("      // Cholesky of M, right-looking, in place; NaN if not SPD\n",
     f"      {ph('chol')}\n", ""),
    ("      for (int e = lane; e < nl; e += 32) {\n        int i, j;\n"
     "        tri(e, i, j);\n        ks(L, k, nl)[e]", f"      {ph('ksolve')}\n",
     ""),
    ("      // P <- sym(Q + A' Pb A - K' B'PA)\n", f"      {ph('pupd')}\n", ""),
    ("  auto vector_bwd_knot = [&](int k, auto rc, auto rcx) {\n    __syncwarp();\n",
     "", f"    {ph('vector')}\n"),
    ("  auto vector_fwd = [&](auto rc, auto rcx) -> float {\n", "",
     f"    {ph('vector')}\n"),
    ("    float sz_aff = 0.f;\n", f"    {ph('muaff')}\n", ""),
    ("      for (int e = lane; e < nl; e += 32) {\n        int i, j;\n"
     "        tri(e, i, j);\n        S.M[i * nu + j] = ks(L, k, nl)[e];",
     f"      {ph('load')}\n", ""),
    ("    const float step = nmin(a.frac * vector_fwd(rc_cor, rcx_cor), 1.f);\n",
     "", f"    {ph('update')}\n"),
    ("  if (lane == 0) {\n    const bool conv = done ||", "  PH_FLUSH;\n", ""),
]


def instrument(src: str) -> tuple[str, str]:
    """(version, instrumented source) of a resident_ipm.cu."""
    for version, anchors in (("staged", STAGED), ("sync", SYNC)):
        if all(src.count(a) == 1 for a, _, _ in anchors):
            break
    else:
        raise SystemExit("ipm_phases.py: this resident_ipm.cu matches neither "
                         "anchor table; bring the table up to date")
    for anchor, before, after in anchors:
        src = src.replace(anchor, before + anchor + after)
    head = "#include <stdint.h>\n"
    src = src.replace(head, head + PRELUDE, 1)
    return version, src + EPILOGUE


def measure(tree: Path, B: int) -> dict:
    """Child process: instrument and run `tree`'s kernel at batch B."""
    sys.path.insert(0, str(tree))
    import torch

    from apf_quadruped_tpu_torch import _kernels, planner, problems
    from apf_quadruped_tpu_torch.config import (EngineConfig, MpcConfig,
                                                SolverConfig)
    from apf_quadruped_tpu_torch.ops import cuda_riccati as cr

    dev = torch.device("cuda")
    cfg = EngineConfig(mpc=MpcConfig(horizon=20, dt=0.025),
                       solver=SolverConfig())
    x0, refs = problems.bench_problem(cfg, B, seed=0, device=dev)
    qp = planner.stage_qp(cfg, x0, refs)
    configs = {"SolverConfig()": SolverConfig(),
               "reltol=abstol=0": SolverConfig(reltol=0.0, abstol=0.0)}

    def event_ms(sc, reps=10):
        cr.solve_stage_qp_resident(qp, sc)
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            cr.solve_stage_qp_resident(qp, sc)
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / reps

    plain_ms = {k: event_ms(sc) for k, sc in configs.items()}
    version, src = instrument((_kernels.CSRC / "resident_ipm.cu").read_text())
    out_dir = ROOT / "_checkout" / "phases" / hashlib.sha256(
        src.encode()).hexdigest()[:12]
    out_dir.mkdir(parents=True, exist_ok=True)
    (out_dir / "resident_ipm.cu").write_text(src)
    _kernels.CSRC = out_dir
    _kernels.resident_ipm.cache_clear()
    if hasattr(_kernels, "resident_ipm_layout"):
        _kernels.resident_ipm_layout.cache_clear()
    lib = _kernels.resident_ipm()
    lib.resident_ipm_phases.argtypes = [ctypes.POINTER(ctypes.c_ulonglong),
                                        ctypes.c_int]
    lib.resident_ipm_phases.restype = ctypes.c_int
    log = Path(lib._name).parent / "build.log"
    ptxas = [ln.strip() for ln in log.read_text().splitlines()
             if "registers" in ln or "stack frame" in ln]
    counts = (ctypes.c_ulonglong * (NPH + 1))()
    result = {"tree": str(tree), "version": version, "ptxas": ptxas,
              "batch": B, "configs": {}}
    for name, sc in configs.items():
        inst_ms = event_ms(sc)
        lib.resident_ipm_phases(counts, 1)
        sol = cr.solve_stage_qp_resident(qp, sc)
        check = lib.resident_ipm_phases(counts, 1)
        if check != 0:
            raise RuntimeError(f"reading the phase counters: CUDA error "
                               f"{check}")
        cyc = [int(c) for c in counts[:NPH]]
        warps = int(counts[NPH])
        total = sum(cyc)
        result["configs"][name] = {
            "kernel_ms": plain_ms[name], "instrumented_ms": inst_ms,
            "warps": warps, "mean_iters": float(sol.iters.float().mean()),
            "max_iters": int(sol.iters.max()),
            "cycles_per_warp": total / max(warps, 1),
            "share": {p: c / total for p, c in zip(PHASES, cyc) if c}}
    return result


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", type=Path, default=None,
                    help="another tree (e.g. an earlier commit) to "
                         "measure beside this one")
    ap.add_argument("--batch", type=int, default=2048,
                    help="scenarios (default 2048: one wave on an H100)")
    ap.add_argument("--child", type=Path, default=None,
                    help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child is not None:
        print(json.dumps(measure(args.child.resolve(), args.batch)))
        return
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("ipm_phases.py needs a CUDA card")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    trees = [("this", ROOT)] + ([("other", args.parent)] if args.parent
                                else [])
    for tag, tree in trees:
        proc = subprocess.run([sys.executable, __file__, "--child",
                               str(tree), "--batch", str(args.batch)],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise SystemExit(f"{tag}: {proc.stderr[-4000:]}")
        res = json.loads(proc.stdout.strip().splitlines()[-1])
        print(f"[{tag}] {res['version']} kernel from {res['tree']}, "
              f"B={res['batch']}; "
              f"instrumented build: {'; '.join(res['ptxas'])}", flush=True)
        for name, r in res["configs"].items():
            shares = ", ".join(f"{p} {100 * s:.1f}%"
                               for p, s in r["share"].items())
            print(f"[{tag}] {name}: kernel {r['kernel_ms']:.3f} ms "
                  f"(instrumented {r['instrumented_ms']:.3f} ms), iters mean "
                  f"{r['mean_iters']:.3f} max {r['max_iters']}, "
                  f"{r['cycles_per_warp']:.0f} cycles a warp: {shares}",
                  flush=True)


if __name__ == "__main__":
    main()
