"""Build and load the port's CUDA kernels: nvcc -> shared library -> ctypes.

The sources in csrc/ are compiled at first use, for Hopper (sm_90a), into
`_build/<name>-<hash>/` beside this file (listed in .gitignore); the hash
covers the sources and the flags, so an edited source rebuilds.  A failed
build or load raises: there is no fallback.  nvcc is looked up on PATH,
then under $CUDA_HOME (default /usr/local/cuda).
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parent / "_build"

# no --use_fast_math: approximate division and flush-to-zero change the
# interior point's late iterations
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def find_nvcc() -> str:
    nvcc = shutil.which("nvcc")
    if nvcc is not None:
        return nvcc
    candidate = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if candidate.is_file():
        return str(candidate)
    raise RuntimeError(
        "nvcc not found on PATH or under $CUDA_HOME: the port's CUDA kernels "
        f"are built from {CSRC} at first use and need the CUDA toolkit")


def build(name: str, sources: list[Path]) -> Path:
    """Compile `sources` into lib<name>.so (cached by content); the
    compiler's output, with the ptxas register/spill report, is kept in
    build.log beside it."""
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources:
        digest.update(src.read_bytes())
    out_dir = BUILD_ROOT / f"{name}-{digest.hexdigest()[:16]}"
    lib = out_dir / f"lib{name}.so"
    if lib.exists():
        return lib
    nvcc = find_nvcc()
    out_dir.mkdir(parents=True, exist_ok=True)
    tmp = out_dir / f"lib{name}.so.{os.getpid()}.tmp"
    proc = subprocess.run([nvcc, *NVCC_FLAGS, "-o", str(tmp),
                           *map(str, sources)], capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed to build {name} "
                           f"(exit {proc.returncode}):\n{proc.stderr}")
    (out_dir / "build.log").write_text(proc.stdout + proc.stderr)
    os.replace(tmp, lib)
    return lib


class IpmArgs(ctypes.Structure):
    """Mirror of `struct IpmArgs` in csrc/resident_ipm.cu (same order)."""

    _fields_ = ([(f, ctypes.c_void_p) for f in (
        "knots", "x0", "G", "R", "Q", "wu", "wz", "ws", "wvalid", "Cx", "acc",
        "st", "stat", "scratch")]
        + [(f, ctypes.c_int) for f in ("B", "H", "m", "mc", "iters")]
        + [(f, ctypes.c_float) for f in (
            "reltol", "abstol", "sigma_pow", "frac", "w_clip", "min_slack",
            "warm_floor", "reg")])


@functools.cache
def resident_ipm(src: Path = CSRC / "resident_ipm.cu",
                 name: str = "resident_ipm") -> ctypes.CDLL:
    """The resident Riccati IPM library (csrc/resident_ipm.cu: the float32
    and the bf16-storage instance, or another version of it at `src`,
    built as `name`), built and loaded once per process."""
    lib = ctypes.CDLL(str(build(name, [src])))
    lib.resident_ipm_launch.argtypes = [ctypes.POINTER(IpmArgs),
                                        ctypes.c_void_p]
    lib.resident_ipm_launch.restype = ctypes.c_int
    # (args, the (B, H, AB_REC) bf16 blocks of A and B', stream); absent
    # from a tree from before the bf16 instance
    bf16 = getattr(lib, "resident_ipm_bf16_launch", None)
    if bf16 is not None:
        bf16.argtypes = [ctypes.POINTER(IpmArgs), ctypes.c_void_p,
                         ctypes.c_void_p]
        bf16.restype = ctypes.c_int
    lib.resident_ipm_layout.argtypes = [ctypes.POINTER(ctypes.c_int),
                                        ctypes.c_int]
    lib.resident_ipm_layout.restype = ctypes.c_int
    return lib


class QpArgs(ctypes.Structure):
    """Mirror of `struct QpArgs` in csrc/resident_qp.cu (same order)."""

    _fields_ = ([(f, ctypes.c_void_p) for f in (
        "P", "q", "A", "b", "G", "h", "em", "im", "x", "y", "z", "s", "conv",
        "iters", "gap", "res")]
        + [(f, ctypes.c_int) for f in ("B", "n", "p", "m", "n_iter",
                                       "refine")]
        + [(f, ctypes.c_float) for f in (
            "reltol", "abstol", "frac", "sigma_pow", "static_reg", "eq_reg",
            "min_slack", "w_clip")])


@functools.cache
def resident_qp(src: Path = CSRC / "resident_qp.cu",
                name: str = "resident_qp") -> ctypes.CDLL:
    """The resident whole-body QP library (csrc/resident_qp.cu, or another
    version of it at `src`, built as `name`), built and loaded once per
    process."""
    lib = ctypes.CDLL(str(build(name, [src])))
    lib.resident_qp_launch.argtypes = [ctypes.POINTER(QpArgs),
                                       ctypes.c_void_p]
    lib.resident_qp_launch.restype = ctypes.c_int
    lib.resident_qp_limits.argtypes = [ctypes.POINTER(ctypes.c_int)] * 3
    lib.resident_qp_limits.restype = None
    lib.resident_qp_prefer_shared.argtypes = []
    lib.resident_qp_prefer_shared.restype = ctypes.c_int
    return lib


@functools.cache
def spd_chol(src: Path = CSRC / "spd_chol.cu",
             name: str = "spd_chol") -> ctypes.CDLL:
    """The batched SPD factor / substitution library (csrc/spd_chol.cu, or
    another version of it at `src`, built as `name`), built and loaded
    once per process."""
    lib = ctypes.CDLL(str(build(name, [src])))
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.spd_factor_launch.argtypes = [ptr, ptr, ptr, i32, i32, ptr]
    lib.spd_factor_launch.restype = i32
    lib.spd_sub_launch.argtypes = [ptr, ptr, ptr, ptr, i32, i32, i32, ptr]
    lib.spd_sub_launch.restype = i32
    lib.spd_solve_launch.argtypes = [ptr, ptr, ptr, i32, i32, i32, ptr]
    lib.spd_solve_launch.restype = i32
    lib.spd_chol_max_n.argtypes = []
    lib.spd_chol_max_n.restype = i32
    return lib


@functools.cache
def fused_riccati(src: Path = CSRC / "fused_riccati.cu",
                  name: str = "fused_riccati") -> ctypes.CDLL:
    """The fused Riccati passes' library (csrc/fused_riccati.cu: rollout,
    factor and vector kernels, each with float32 and bf16 storage of A and
    B, or another version of it at `src`, built as `name`), built and
    loaded once per process."""
    lib = ctypes.CDLL(str(build(name, [src])))
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    dims = [i32] * 5 + [ptr]                      # B, H, nx, nu, m, stream
    for store in ("", "_bf16"):
        for name_, n in (("rollout", 12), ("factor", 9), ("vector", 10)):
            fn = getattr(lib, f"fused_{name_}{store}_launch", None)
            if fn is None and store:   # a tree from before the bf16 kernels
                continue
            fn.argtypes = [ptr] * n + dims
            fn.restype = i32
    lib.fused_riccati_limits.argtypes = [ctypes.POINTER(i32)] * 4
    lib.fused_riccati_limits.restype = None
    return lib


@functools.cache
def fused_riccati_limits() -> tuple[int, int, int, int]:
    """(NX_MAX, NU_MAX, M_MAX, the largest H of the rollout and the vector
    pass, which keep H knots' x and kff in shared memory) of the fused
    kernels."""
    vals = [ctypes.c_int() for _ in range(4)]
    fused_riccati().fused_riccati_limits(*[ctypes.byref(v) for v in vals])
    return tuple(v.value for v in vals)


@functools.cache
def apf_mark() -> ctypes.CDLL:
    """The stage marks' library (csrc/apf_mark.cu: one empty kernel a
    stage), built and loaded once per process, at the first use of
    runtime/profiling.py's marks."""
    lib = ctypes.CDLL(str(build("apf_mark", [CSRC / "apf_mark.cu"])))
    lib.apf_mark_launch.argtypes = [ctypes.c_int, ctypes.c_void_p]
    lib.apf_mark_launch.restype = ctypes.c_int
    return lib


# the names of resident_ipm_layout's values, in its order
_IPM_LAYOUT = ("NX", "NU", "M_MAX", "MC_MAX", "IN_REC", "IN_A", "IN_BT",
               "IN_Q", "IN_MASK", "IN_H", "IN_CX", "IN_MX", "ST_REC", "ST_U",
               "ST_X", "ST_Z", "ST_S", "ST_ZX", "ST_SX", "SC_REC", "AB_A",
               "AB_BT", "AB_REC", "AB_IN0")


@functools.cache
def resident_ipm_layout() -> dict[str, int]:
    """The resident kernel's compiled widths and limits (NX, NU, M_MAX,
    MC_MAX), its per-knot record layout (offsets in floats) and the bf16
    instance's: its block of A and B' (AB_A, AB_BT, AB_REC, in bf16
    elements) and the first field its float32 record holds (AB_IN0)."""
    vals = (ctypes.c_int * len(_IPM_LAYOUT))()
    n = resident_ipm().resident_ipm_layout(vals, len(_IPM_LAYOUT))
    if n != len(_IPM_LAYOUT):
        raise RuntimeError(f"resident_ipm_layout gave {n} values, expected "
                           f"{len(_IPM_LAYOUT)}")
    return dict(zip(_IPM_LAYOUT, vals))
