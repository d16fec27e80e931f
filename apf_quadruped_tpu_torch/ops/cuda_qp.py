"""The batched whole-body QP in one launch on the GPU: the wrapper of
csrc/resident_qp.cu.

The kernel runs all of ops/qpsolve.py::_solve_qp_impl (the masks, the
initial point, the fixed Mehrotra iterations with their refinement, the
NaN quarantine) for a batch of QPs with n <= N_MAX variables, p <= P_MAX
equality rows and m <= M_MAX inequality rows, one warp a QP.  `takes` is
the route's rule, on device, dtype and shape alone: ops/qpsolve.py sends
what it takes here and everything else (the CPU, another dtype, the
condensed planner's n = 12H) op by op, before any launch.  The wrapper
checks what the kernel takes, makes the inputs contiguous with one batch
axis in front (P, A and G at the kernel's compiled widths, 16-byte
aligned: a smaller or misaligned QP is copied, zero-padded; the WBC's pass
as they are), allocates the outputs and launches on the current stream;
it never falls back to another implementation.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from .. import _kernels
from .cuda_chol import _on

# the kernel's compiled limits (csrc/resident_qp.cu N and M_MAX; checked
# against the library when it loads)
N_MAX = 30
P_MAX = 30
M_MAX = 72

_FIELDS = ("P", "q", "A", "b", "G", "h", "eq_mask", "ineq_mask")


def _sizes(qp) -> tuple[int, int, int]:
    return qp.q.shape[-1], qp.b.shape[-1], qp.h.shape[-1]


def takes(qp) -> bool:
    """Whether `qp` (a qpsolve.QPData) goes to the kernel: CUDA tensors, every
    field float32, 1 <= n <= N_MAX, 1 <= p <= P_MAX, 1 <= m <= M_MAX.  Reads
    only each field's device, dtype and shape."""
    if qp.P.device.type != "cuda":
        return False
    if any(getattr(qp, f).dtype != torch.float32 for f in _FIELDS):
        return False
    n, p, m = _sizes(qp)
    return 1 <= n <= N_MAX and 1 <= p <= P_MAX and 1 <= m <= M_MAX


@functools.cache
def _checked_lib() -> ctypes.CDLL:
    lib = _kernels.resident_qp()
    vals = [ctypes.c_int() for _ in range(3)]
    lib.resident_qp_limits(*[ctypes.byref(v) for v in vals])
    if tuple(v.value for v in vals) != (N_MAX, P_MAX, M_MAX):
        raise RuntimeError(f"resident_qp limits {[v.value for v in vals]} "
                           f"differ from the wrapper's "
                           f"{(N_MAX, P_MAX, M_MAX)}")
    return lib


@functools.cache
def _lib_on(index: int) -> ctypes.CDLL:
    """The library, its kernel's shared-memory carveout preferred on device
    `index` (the current device), once a device."""
    lib = _checked_lib()
    err = lib.resident_qp_prefer_shared()
    if err != 0:
        raise RuntimeError(f"resident QP kernel: setting its shared-memory "
                           f"carveout failed: CUDA error {err}")
    return lib


def _padded(t: torch.Tensor, rows: int) -> torch.Tensor:
    """(nb, r, c) `t` as the kernel stages it: (nb, rows, N_MAX), zero past
    r and c, in a 16-byte-aligned buffer (copied only where it is not)."""
    nb, r, c = t.shape
    if (r, c) == (rows, N_MAX) and t.data_ptr() % 16 == 0:
        return t
    out = torch.zeros((nb, rows, N_MAX), dtype=t.dtype, device=t.device)
    out[:, :r, :c] = t
    return out


def _check(qp) -> tuple[tuple, int, int, int]:
    """(batch shape, n, p, m) of a QP the kernel takes; raises otherwise."""
    for f in _FIELDS:
        t = getattr(qp, f)
        if t.device.type != "cuda":
            raise ValueError(f"solve_qp_resident: the kernel takes CUDA "
                             f"tensors, got {f} on {t.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"solve_qp_resident: the kernel runs in float32, "
                            f"got {f} of {t.dtype}")
    n, p, m = _sizes(qp)
    if not (1 <= n <= N_MAX and 1 <= p <= P_MAX and 1 <= m <= M_MAX):
        raise ValueError(f"solve_qp_resident: the kernel takes 1 <= n <= "
                         f"{N_MAX}, 1 <= p <= {P_MAX}, 1 <= m <= {M_MAX}; "
                         f"got n={n}, p={p}, m={m}")
    tails = {"P": (n, n), "q": (n,), "A": (p, n), "b": (p,), "G": (m, n),
             "h": (m,), "eq_mask": (p,), "ineq_mask": (m,)}
    for f, tail in tails.items():
        t = getattr(qp, f)
        if tuple(t.shape[t.dim() - len(tail):]) != tail:
            raise ValueError(f"solve_qp_resident: {f} of shape "
                             f"{tuple(t.shape)} does not end in {tail}")
    batch = _broadcast([tuple(getattr(qp, f).shape[:getattr(qp, f).dim()
                                                 - len(tail)])
                        for f, tail in tails.items()])
    return batch, n, p, m


def _broadcast(shapes: list[tuple]) -> tuple:
    """The shape the batch shapes broadcast to (torch.broadcast_shapes costs
    seconds on its first call: it imports the symbolic-shape machinery)."""
    out = []
    for dims in zip(*(((1,) * (max(map(len, shapes)) - len(s)) + s)
                      for s in shapes)):
        big = {d for d in dims if d != 1}
        if len(big) > 1:
            raise ValueError(f"solve_qp_resident: batch shapes {shapes} do "
                             f"not broadcast")
        out.append(big.pop() if big else 1)
    return tuple(out)


def solve_qp_resident(qp, cfg):
    """(x, y, z, s, converged, iters, gap, res_norm) of qpsolve.solve_qp for
    a QP `takes` accepts, SolverConfig `cfg`, in one kernel launch; any
    leading batch shape (the fields broadcast against each other)."""
    batch, n, p, m = _check(qp)
    nb = math.prod(batch)
    dev = qp.P.device
    tails = (("P", (n, n)), ("q", (n,)), ("A", (p, n)), ("b", (p,)),
             ("G", (m, n)), ("h", (m,)), ("eq_mask", (p,)),
             ("ineq_mask", (m,)))
    ins = {f: torch.broadcast_to(getattr(qp, f), batch + tail)
           .reshape((nb,) + tail).contiguous() for f, tail in tails}
    f32 = dict(dtype=torch.float32, device=dev)
    out = {"x": torch.empty((nb, n), **f32), "y": torch.empty((nb, p), **f32),
           "z": torch.empty((nb, m), **f32), "s": torch.empty((nb, m), **f32),
           "conv": torch.empty((nb,), dtype=torch.bool, device=dev),
           "iters": torch.empty((nb,), dtype=torch.int32, device=dev),
           "gap": torch.empty((nb,), **f32), "res": torch.empty((nb,), **f32)}
    if nb > 0:
        ins.update(P=_padded(ins["P"], N_MAX), A=_padded(ins["A"], P_MAX),
                   G=_padded(ins["G"], m + m % 2))
        args = _kernels.QpArgs(
            P=ins["P"].data_ptr(), q=ins["q"].data_ptr(),
            A=ins["A"].data_ptr(), b=ins["b"].data_ptr(),
            G=ins["G"].data_ptr(), h=ins["h"].data_ptr(),
            em=ins["eq_mask"].data_ptr(), im=ins["ineq_mask"].data_ptr(),
            **{k: v.data_ptr() for k, v in out.items()},
            B=nb, n=n, p=p, m=m, n_iter=cfg.iters, refine=cfg.refine_steps,
            reltol=cfg.reltol, abstol=cfg.abstol,
            frac=cfg.frac_to_boundary, sigma_pow=cfg.sigma_pow,
            static_reg=cfg.static_reg, eq_reg=cfg.eq_reg,
            min_slack=cfg.min_slack, w_clip=cfg.w_clip)
        with _on(dev):
            lib = _lib_on(torch.cuda.current_device())
            stream = torch.cuda.current_stream(dev).cuda_stream
            err = lib.resident_qp_launch(ctypes.byref(args),
                                         ctypes.c_void_p(stream))
        if err != 0:
            raise RuntimeError(f"resident QP kernel launch failed: CUDA error "
                               f"{err}")
        solve_qp_resident.launches += 1
    return (out["x"].reshape(batch + (n,)), out["y"].reshape(batch + (p,)),
            out["z"].reshape(batch + (m,)), out["s"].reshape(batch + (m,)),
            out["conv"].reshape(batch), out["iters"].reshape(batch),
            out["gap"].reshape(batch), out["res"].reshape(batch))


# kernel launches made by this process (runtime/graph.py counts a replay's)
solve_qp_resident.launches = 0
