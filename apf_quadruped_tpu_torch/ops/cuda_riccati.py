"""The resident Riccati IPM on the GPU: wrapper of csrc/resident_ipm.cu.

Port of apf_quadruped_tpu/ops/pallas_riccati.py::solve_stage_qp_resident.
The whole Mehrotra loop of ops.riccati.solve_stage_qp runs in one CUDA
kernel launch, one warp per scenario (see the note at the top of the
source).  This module flattens the batch dims of the StageQP into one
contiguous float32 batch axis in front, as the kernel reads it, allocates
its outputs and scratch, launches it on the current stream, and turns the
outputs back into a StageSolution with the scan's NaN quarantine.

Dispatch is by the tensors' device: CPU tensors go to the plain version,
ops.riccati.solve_stage_qp; CUDA tensors launch the kernel or raise.
Unlike the TPU kernel, the accel rows' z/s sit in the scan's layout
(accel rows last) inside the kernel too, so warm z/s pass through as they
are.
"""

from __future__ import annotations

import ctypes
import math

import torch

from .. import _kernels
from ..config import SolverConfig
from .riccati import (StageQP, StageSolution, WarmStart, check_solver_config,
                      finalize, solve_stage_qp)


def solve_stage_qp_resident(qp: StageQP, cfg: SolverConfig = SolverConfig(),
                            warm: WarmStart | None = None) -> StageSolution:
    """Same contract and outputs as ops.riccati.solve_stage_qp."""
    check_solver_config(cfg)
    device = qp.x0.device
    if device.type == "cpu":
        return solve_stage_qp(qp, cfg, warm)
    if device.type != "cuda":
        raise ValueError(f"solve_stage_qp_resident: unsupported device "
                         f"{device}")
    return _launch(qp, cfg, warm)


# kernel launches made by this process (chip_smoke.py reads it)
solve_stage_qp_resident.launches = 0


def _launch(qp: StageQP, cfg: SolverConfig,
            warm: WarmStart | None) -> StageSolution:
    lib = _kernels.resident_ipm()
    dev = qp.x0.device
    f32 = torch.float32
    if qp.x0.dtype != f32:
        raise TypeError(f"the CUDA resident IPM runs in float32, got "
                        f"{qp.x0.dtype}")
    batch = qp.x0.shape[:-1]
    nb = math.prod(batch)
    H, nx, nu, m = qp.A.shape[-3], qp.A.shape[-1], qp.B.shape[-1], \
        qp.h.shape[-1]
    has_x = qp.Cx is not None
    mc = qp.Cx.shape[0] if has_x else 0
    macc = qp.acc_rhs is not None
    mt = m + (12 if macc else 0)
    nx_max, nu_max, m_max, mc_max = _kernels.resident_ipm_limits()
    if nx > nx_max or nu > nu_max or m > m_max or mc > mc_max:
        raise ValueError(
            f"resident IPM kernel supports nx<={nx_max}, nu<={nu_max}, "
            f"m<={m_max}, mc<={mc_max}; got nx={nx}, nu={nu}, m={m}, mc={mc}")
    if macc and nx != 13:
        raise ValueError("accel rows (acc_rhs) assume the 13-state SRB "
                         f"layout; got nx={nx}")
    if nb == 0:
        raise ValueError("empty batch")

    def flat(v, rows):
        """(batch..) + rows -> (nb,) + rows, contiguous float32."""
        v = torch.broadcast_to(v.to(device=dev, dtype=f32), batch + rows)
        return v.reshape((nb,) + rows).contiguous()

    def const(v):
        return v.to(device=dev, dtype=f32).contiguous()

    mask = flat(qp.mask, (H, m))
    h = torch.where(mask > 0, flat(qp.h, (H, m)), torch.ones_like(mask))
    keep = {                                     # inputs, alive until launch
        "A": flat(qp.A, (H, nx, nx)), "Bm": flat(qp.B, (H, nx, nu)),
        "q": flat(qp.qlin, (H, nx)), "mask": mask, "h": h,
        "x0": flat(qp.x0, (nx,)), "G": const(qp.G), "R": const(qp.R),
        "Q": const(qp.Q)}
    if warm is not None:
        keep.update(wu=flat(warm.u, (H, nu)), wz=flat(warm.z, (H, mt)),
                    ws=flat(warm.s, (H, mt)),
                    wvalid=flat(warm.valid, ()))
    if has_x:
        maskx = flat(qp.mask_x, (H, mc))
        keep.update(Cx=const(qp.Cx), maskx=maskx,
                    cx=torch.where(maskx > 0, flat(qp.cx, (H, mc)),
                                   torch.ones_like(maskx)))
    if macc:
        keep["acc"] = const(qp.acc_rhs)

    def empty(*shape):
        return torch.empty(shape, dtype=f32, device=dev)

    out = {"u": empty(nb, H, nu), "x": empty(nb, H, nx),
           "z": empty(nb, H, mt), "s": empty(nb, H, mt),
           "zx": empty(nb, H, mc), "sx": empty(nb, H, mc),
           "stat": empty(nb, 4),
           "scratch": empty(nb,
                            lib.resident_ipm_scratch_rows(H, nx, nu, mt, mc))}
    args = _kernels.IpmArgs(
        **{k: v.data_ptr() for k, v in {**keep, **out}.items()},
        B=nb, H=H, nx=nx, nu=nu, m=m, mc=mc, iters=cfg.iters,
        reltol=cfg.reltol, abstol=cfg.abstol, sigma_pow=cfg.sigma_pow,
        frac=cfg.frac_to_boundary, w_clip=cfg.w_clip,
        min_slack=cfg.min_slack, warm_floor=cfg.warm_floor,
        reg=cfg.static_reg)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.resident_ipm_launch(ctypes.byref(args),
                                      ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(f"resident IPM kernel launch failed: CUDA error "
                           f"{err}")
    solve_stage_qp_resident.launches += 1

    def unflat(v):
        """(nb,) + rows -> batch + rows."""
        return v.reshape(batch + v.shape[1:])

    stat = unflat(out["stat"])
    return finalize(unflat(out["u"]), unflat(out["x"]), unflat(out["z"]),
                    unflat(out["s"]), stat[..., 0] > 0.5,
                    stat[..., 1].to(torch.int32), stat[..., 2],
                    stat[..., 3],
                    unflat(out["zx"]) if has_x else None,
                    unflat(out["sx"]) if has_x else None)
