"""The batched SPD factor, substitution and factor-and-solve on the GPU:
wrappers of csrc/spd_chol.cu.

Ports of apf_quadruped_tpu/ops/pallas_chol.py::chol_factor_blocked,
::chol_sub_blocked and ::chol_solve_blocked.  Each wrapper checks what its
kernel takes (a CUDA float32 tensor, one batch axis in front, n <= 64),
makes the input contiguous, allocates the outputs and launches on the
current stream; it never falls back to another implementation.  The plain
versions live in ops/chol.py, which also routes CPU tensors to them.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools

import torch

from .. import _kernels


def _check(t: torch.Tensor, what: str, ndim: int) -> torch.Tensor:
    if t.device.type != "cuda":
        raise ValueError(f"{what}: the spd_chol kernels take CUDA tensors, "
                         f"got {t.device}")
    if t.dtype != torch.float32:
        raise TypeError(f"{what}: the spd_chol kernels run in float32, got "
                        f"{t.dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{what}: expected {ndim} dims, got shape "
                         f"{tuple(t.shape)}")
    return t.contiguous()


@functools.cache
def _max_n() -> int:
    return _kernels.spd_chol().spd_chol_max_n()


def _on(dev):
    """The device's context, entered only when it is not current (the
    launches go to the current device)."""
    if dev.index is None or dev.index == torch.cuda.current_device():
        return contextlib.nullcontext()
    return torch.cuda.device(dev)


def _stream(dev) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)


def chol_factor(H: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """H (B, n, n) SPD -> (L (B, n, n), dinv (B, n)); NaN on a lane whose
    matrix is not positive definite."""
    H = _check(H, "chol_factor", 3)
    B, n, n2 = H.shape
    if n != n2:
        raise ValueError(f"chol_factor: H must be square, got {tuple(H.shape)}")
    if n > _max_n():
        raise ValueError(f"chol_factor: the kernel takes n <= {_max_n()}, "
                         f"got n={n}")
    L = torch.empty_like(H)
    dinv = torch.empty((B, n), dtype=H.dtype, device=H.device)
    if B == 0:
        return L, dinv
    lib = _kernels.spd_chol()
    with _on(H.device):
        err = lib.spd_factor_launch(H.data_ptr(), L.data_ptr(),
                                    dinv.data_ptr(), B, n, _stream(H.device))
    if err != 0:
        raise RuntimeError(f"spd_factor kernel launch failed: CUDA error {err}")
    chol_factor.launches += 1
    return L, dinv


def chol_sub(L: torch.Tensor, dinv: torch.Tensor,
             rhs: torch.Tensor) -> torch.Tensor:
    """X (B, n, k) with L L' X = rhs, for L (B, n, n), dinv (B, n) from
    chol_factor and rhs (B, n, k)."""
    L = _check(L, "chol_sub", 3)
    dinv = _check(dinv, "chol_sub", 2)
    rhs = _check(rhs, "chol_sub", 3)
    B, n, _ = L.shape
    k = rhs.shape[-1]
    if L.shape != (B, n, n) or dinv.shape != (B, n) or rhs.shape[:2] != (B, n):
        raise ValueError(f"chol_sub: shapes L {tuple(L.shape)}, dinv "
                         f"{tuple(dinv.shape)}, rhs {tuple(rhs.shape)} do not "
                         f"fit (B, n, n), (B, n), (B, n, k)")
    if n > _max_n():
        raise ValueError(f"chol_sub: the kernel takes n <= {_max_n()}, "
                         f"got n={n}")
    X = torch.empty_like(rhs)
    if B == 0 or k == 0:
        return X
    lib = _kernels.spd_chol()
    with _on(L.device):
        err = lib.spd_sub_launch(L.data_ptr(), dinv.data_ptr(),
                                 rhs.data_ptr(), X.data_ptr(), B, n, k,
                                 _stream(L.device))
    if err != 0:
        raise RuntimeError(f"spd_sub kernel launch failed: CUDA error {err}")
    chol_sub.launches += 1
    return X


def chol_solve(M: torch.Tensor, rhs: torch.Tensor) -> torch.Tensor:
    """X (B, n, k) with M X = rhs, for SPD M (B, n, n) and rhs (B, n, k):
    factor and substitution in one launch; NaN on a lane whose matrix is
    not positive definite."""
    M = _check(M, "chol_solve", 3)
    rhs = _check(rhs, "chol_solve", 3)
    B, n, _ = M.shape
    k = rhs.shape[-1]
    if M.shape != (B, n, n) or rhs.shape[:2] != (B, n):
        raise ValueError(f"chol_solve: shapes M {tuple(M.shape)}, rhs "
                         f"{tuple(rhs.shape)} do not fit (B, n, n), (B, n, k)")
    if n > _max_n():
        raise ValueError(f"chol_solve: the kernel takes n <= {_max_n()}, "
                         f"got n={n}")
    X = torch.empty_like(rhs)
    if B == 0 or k == 0:
        return X
    lib = _kernels.spd_chol()
    with _on(M.device):
        err = lib.spd_solve_launch(M.data_ptr(), rhs.data_ptr(), X.data_ptr(),
                                   B, n, k, _stream(M.device))
    if err != 0:
        raise RuntimeError(f"spd_solve kernel launch failed: CUDA error {err}")
    chol_solve.launches += 1
    return X


# kernel launches made by this process (chip_smoke.py reads them)
chol_factor.launches = 0
chol_sub.launches = 0
chol_solve.launches = 0
