"""The Riccati IPM on the GPU: the resident kernel and the fused passes.

Ports of apf_quadruped_tpu/ops/pallas_riccati.py's two kernel backends.

`solve_stage_qp_resident` (backend "riccati_resident", csrc/resident_ipm.cu):
the whole Mehrotra loop of ops.riccati.solve_stage_qp in one CUDA kernel
launch, one warp per scenario.  The wrapper flattens the batch dims of the
StageQP into one float32 batch axis in front and packs each knot's data
into the kernel's 16-byte aligned knot record (A, B', q, mask, h, cx,
mask_x; states padded to 13 and inputs to 12 with zeros, the padded
inputs' block of R the identity, which changes no sum), allocates the
iterate and scratch records, launches the kernel on the current stream,
and turns the iterate's fields back into a StageSolution with the scan's
NaN quarantine.  Unlike the TPU kernel, the accel rows' z/s sit in the
scan's layout (accel rows last) inside the kernel too, so warm z/s pass
through as they are.  CPU tensors go to the plain version,
ops.riccati.solve_stage_qp.

`solve_stage_qp_fused` (backend "riccati_fused", csrc/fused_riccati.cu):
the same Mehrotra IPM written in PyTorch around three kernels a pass each,
as the JAX package's `_solve_fused_impl`: per iteration one
`fused_rollout` (rollout, costates, stationarity residual), one
`fused_factor` (the Riccati factorization) and two `fused_vector` (the
predictor's and the corrector's affine-LQR pass).  Arrays are batch-first
and contiguous per scenario.  The loop reads nothing back to the host, so
it runs all cfg.iters iterations; a lane that is done takes zero steps.
It has no state rows and no accel rows (planner.effective_backend sends
base_box / base_acc plans to the resident kernel).
Each pass wrapper launches its kernel on CUDA tensors (the bf16 kernel
for bfloat16 A and Bm) and takes its plain version (`plain_rollout`,
`plain_factor_pass`, `plain_vector_pass`: loops over the horizon of
batched small matrix products) on CPU tensors.

SolverConfig.stage_bf16 (the JAX package's bf16 storage of the stage
linearizations) applies to both kernel backends, as in the JAX package:
A and B are rounded to bfloat16 (to nearest, ties to even) once a solve,
kept on the device at bf16, and widened to float32 inside the kernels,
which launch their bf16 instances; everything else, and all the algebra,
stays float32.  The resident wrapper puts A and B' in bf16 blocks of
their own beside shorter knot records; the fused IPM casts A and B once
(`bf16_knots`: each knot's matrix on 16 bytes, which the bf16 passes
stage by 16-byte cp.async).  On CPU tensors both backends run their
plain versions on the rounded A and B (riccati.round_stage_bf16), which
the CPU tests hold to the JAX kernels in interpret mode.  The scan
ignores the option.
"""

from __future__ import annotations

import ctypes
import math

import torch

from .. import _kernels
from .._device import constant
from .._precision import highest_precision
from ..config import SolverConfig
from .riccati import (StageQP, StageSolution, WarmStart, _mtv, _mv,
                      finalize, round_stage_bf16, solve_stage_qp, spd_factor,
                      spd_solve)


def solve_stage_qp_resident(qp: StageQP, cfg: SolverConfig = SolverConfig(),
                            warm: WarmStart | None = None) -> StageSolution:
    """Same contract and outputs as ops.riccati.solve_stage_qp; with
    cfg.stage_bf16, those of the scan on A and B rounded to bfloat16
    (riccati.round_stage_bf16), the kernel reading them at bf16."""
    device = qp.x0.device
    if device.type == "cpu":
        if cfg.stage_bf16:
            qp = round_stage_bf16(qp)
        return solve_stage_qp(qp, cfg, warm)
    if device.type != "cuda":
        raise ValueError(f"solve_stage_qp_resident: unsupported device "
                         f"{device}")
    return _launch(qp, cfg, warm)


# kernel launches made by this process (chip_smoke.py reads it)
solve_stage_qp_resident.launches = 0


def _pack(qp: StageQP, cfg: SolverConfig, warm: WarmStart | None,
          lay: dict) -> dict:
    """The resident kernel's inputs, by IpmArgs field (and "ab", the bf16
    blocks of A and B' under cfg.stage_bf16), checked against what the
    kernel takes."""
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
    NX, NU = lay["NX"], lay["NU"]
    if nx > NX or nu > NU or m > lay["M_MAX"] or mc > lay["MC_MAX"]:
        raise ValueError(
            f"resident IPM kernel supports nx<={NX}, nu<={NU}, "
            f"m<={lay['M_MAX']}, mc<={lay['MC_MAX']}; got nx={nx}, nu={nu}, "
            f"m={m}, mc={mc}")
    if macc and nx != 13:
        raise ValueError("accel rows (acc_rhs) assume the 13-state SRB "
                         f"layout; got nx={nx}")
    if nb == 0:
        raise ValueError("empty batch")

    def flat(v, rows):
        """(batch..) + rows -> (nb,) + rows, float32 on the device."""
        v = torch.broadcast_to(v.to(device=dev, dtype=f32), batch + rows)
        return v.reshape((nb,) + rows)

    def padded(v, shape):
        """v in the leading corner of zeros of `shape`: the kernel's widths
        are 13 states and 12 inputs, and zero rows and columns change no
        sum."""
        out = torch.zeros(shape, dtype=f32, device=dev)
        out[tuple(slice(0, n) for n in v.shape)] = v
        return out

    # the knot records: A, B', q, mask, h, cx, mask_x (masked rows' h and
    # cx are 1, as in the scan); with stage_bf16, A and B' go to bf16
    # blocks of their own, rounded as they are copied in, and the records
    # hold the fields from AB_IN0 on
    lo = lay["AB_IN0"] if cfg.stage_bf16 else 0
    knots = torch.zeros((nb, H, lay["IN_REC"] - lo), dtype=f32, device=dev)

    def field(name, n):
        return knots[..., lay[name] - lo:lay[name] - lo + n]

    keep = {"knots": knots}
    if cfg.stage_bf16:
        keep["ab"] = torch.zeros((nb, H, lay["AB_REC"]), dtype=torch.bfloat16,
                                 device=dev)
        a_blk = keep["ab"][..., lay["AB_A"]:lay["AB_A"] + NX * NX]
        bt_blk = keep["ab"][..., lay["AB_BT"]:lay["AB_BT"] + NU * NX]
    else:
        a_blk, bt_blk = field("IN_A", NX * NX), field("IN_BT", NU * NX)
    a_blk.unflatten(-1, (NX, NX))[..., :nx, :nx] = flat(qp.A, (H, nx, nx))
    bt_blk.unflatten(-1, (NU, NX))[..., :nu, :nx] = \
        flat(qp.B, (H, nx, nu)).transpose(-1, -2)
    field("IN_Q", nx)[...] = flat(qp.qlin, (H, nx))
    mask = flat(qp.mask, (H, m))
    field("IN_MASK", m)[...] = mask
    field("IN_H", m)[...] = torch.where(mask > 0, flat(qp.h, (H, m)),
                                        torch.ones_like(mask))
    R = padded(qp.R.to(dev, f32), (NU, NU))
    R.diagonal()[nu:] = 1.0                   # the padded inputs' block
    keep.update(x0=padded(flat(qp.x0, (nx,)), (nb, NX)),
                G=padded(qp.G.to(dev, f32), (m, NU)), R=R,
                Q=padded(qp.Q.to(dev, f32), (NX, NX)))
    if has_x:
        maskx = flat(qp.mask_x, (H, mc))
        field("IN_MX", mc)[...] = maskx
        field("IN_CX", mc)[...] = torch.where(
            maskx > 0, flat(qp.cx, (H, mc)), torch.ones_like(maskx))
        keep["Cx"] = padded(qp.Cx.to(dev, f32), (mc, NX))
    if warm is not None:
        keep.update(wu=padded(flat(warm.u, (H, nu)), (nb, H, NU)),
                    wz=flat(warm.z, (H, mt)).contiguous(),
                    ws=flat(warm.s, (H, mt)).contiguous(),
                    wvalid=flat(warm.valid, ()).contiguous())
    if macc:
        keep["acc"] = qp.acc_rhs.to(dev, f32).contiguous()

    return keep


def _launch(qp: StageQP, cfg: SolverConfig,
            warm: WarmStart | None) -> StageSolution:
    lib = _kernels.resident_ipm()
    lay = _kernels.resident_ipm_layout()
    keep = _pack(qp, cfg, warm, lay)
    dev = qp.x0.device
    f32 = torch.float32
    batch = qp.x0.shape[:-1]
    nb = math.prod(batch)
    H, nx, nu, m = qp.A.shape[-3], qp.A.shape[-1], qp.B.shape[-1], \
        qp.h.shape[-1]
    has_x = qp.Cx is not None
    mc = qp.Cx.shape[0] if has_x else 0
    mt = m + (12 if qp.acc_rhs is not None else 0)
    out = {"st": torch.empty((nb, H, lay["ST_REC"]), dtype=f32, device=dev),
           "stat": torch.empty((nb, 4), dtype=f32, device=dev),
           "scratch": torch.empty((nb, H, lay["SC_REC"]), dtype=f32,
                                  device=dev)}
    ab = keep.get("ab")
    args = _kernels.IpmArgs(
        **{k: v.data_ptr() for k, v in {**keep, **out}.items() if k != "ab"},
        B=nb, H=H, m=m, mc=mc, iters=cfg.iters,
        reltol=cfg.reltol, abstol=cfg.abstol, sigma_pow=cfg.sigma_pow,
        frac=cfg.frac_to_boundary, w_clip=cfg.w_clip,
        min_slack=cfg.min_slack, warm_floor=cfg.warm_floor,
        reg=cfg.static_reg)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        if ab is None:
            err = lib.resident_ipm_launch(ctypes.byref(args),
                                          ctypes.c_void_p(stream))
        else:
            err = lib.resident_ipm_bf16_launch(ctypes.byref(args),
                                               ctypes.c_void_p(ab.data_ptr()),
                                               ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(f"resident IPM kernel launch failed: CUDA error "
                           f"{err}")
    solve_stage_qp_resident.launches += 1

    st = out["st"]

    def view(name, n):
        """The (nb, H, n) field `name` of the iterate -> batch + (H, n)."""
        return st[..., lay[name]:lay[name] + n].reshape(batch + (H, n))

    stat = out["stat"].reshape(batch + (4,))
    return finalize(view("ST_U", nu), view("ST_X", nx), view("ST_Z", mt),
                    view("ST_S", mt), stat[..., 0] > 0.5,
                    stat[..., 1].to(torch.int32), stat[..., 2],
                    stat[..., 3],
                    view("ST_ZX", mc) if has_x else None,
                    view("ST_SX", mc) if has_x else None)


# ---------------------------------------------------------------------------
# the fused passes: plain versions (CPU) and kernel wrappers (CUDA)
# ---------------------------------------------------------------------------

def _widened(ref, *mats):
    """bf16 matrices (A, Bm under stage_bf16) in ref's dtype, exactly."""
    return tuple(t.to(ref.dtype) if t.dtype == torch.bfloat16 else t
                 for t in mats)


def bf16_knots(M):
    """M (B, H, r, c) rounded to bfloat16 (to nearest, ties to even) in the
    layout the bf16 kernels read: each knot's r x c block contiguous and
    starting on 16 bytes, its r c elements padded to a multiple of 8.  A
    (B, H, r, c) view of that buffer, which the pass wrappers take as it
    is."""
    nb, H, r, c = M.shape
    buf = torch.zeros((nb, H, _padded8(r * c)), dtype=torch.bfloat16,
                      device=M.device)
    view = buf[..., :r * c].unflatten(-1, (r, c))
    view.copy_(M)
    return view


def _padded8(n):
    return -(-n // 8) * 8


def _in_bf16_layout(t):
    """t (B, H, r, c) bf16 lies as bf16_knots lays it out."""
    H, r, c = t.shape[1:]
    want = (H * _padded8(r * c), _padded8(r * c), c, 1)
    return t.data_ptr() % 16 == 0 and all(
        n == 1 or st == w for n, st, w in zip(t.shape, t.stride(), want))


def plain_rollout(G, R, Q, A, Bm, q, u, zm, x0):
    """x (B, H, nx) with x_{k+1} = A_k x_k + B_k u_k; rx (B, H, nu) =
    R u_k + B_k' lam_k + G' zm_k with the costates lam_k = Q x_{k+1} + q_k
    + A_{k+1}' lam_{k+1}; gu (B, H, m) = G u_k.  bf16 A, Bm (stage_bf16)
    are widened to G's dtype first, as every plain pass does."""
    A, Bm = _widened(G, A, Bm)
    H = A.shape[1]
    x, xs = x0, []
    for k in range(H):
        x = _mv(A[:, k], x) + _mv(Bm[:, k], u[:, k])
        xs.append(x)
    lam = torch.zeros_like(x0)
    rx = [None] * H
    for k in reversed(range(H)):
        lam_k = xs[k] @ Q.T + q[:, k] + lam
        rx[k] = u[:, k] @ R.T + _mtv(Bm[:, k], lam_k) + zm[:, k] @ G
        lam = _mtv(A[:, k], lam_k)
    return torch.stack(xs, 1), torch.stack(rx, 1), u @ G.T


def plain_factor_pass(G, R, Q, A, Bm, W):
    """The Riccati factorization, backward over the knots from P = Q:
    M_k = R + G' diag(W_k) G + B_k' P B_k -> L (B, H, nu, nu) lower,
    dinv (B, H, nu) = 1 / diag(L), K (B, H, nu, nx) = M_k^-1 B_k' P A_k;
    P <- sym(Q + A_k' P A_k - K_k' B_k' P A_k).  NaN where M_k is not
    positive definite."""
    A, Bm = _widened(G, A, Bm)
    H = A.shape[1]
    P = torch.broadcast_to(Q, A.shape[:1] + Q.shape)
    L, D, K = [None] * H, [None] * H, [None] * H
    for k in reversed(range(H)):
        Ak, Bk = A[:, k], Bm[:, k]
        BtP = Bk.transpose(-1, -2) @ P
        M = R + G.T @ (W[:, k, :, None] * G) + BtP @ Bk
        L[k] = spd_factor(M)
        D[k] = 1.0 / torch.diagonal(L[k], dim1=-2, dim2=-1)
        BtPA = BtP @ Ak
        K[k] = spd_solve(L[k], BtPA)
        Pn = Q + Ak.transpose(-1, -2) @ P @ Ak - K[k].transpose(-1, -2) @ BtPA
        P = 0.5 * (Pn + Pn.transpose(-1, -2))
    return torch.stack(L, 1), torch.stack(D, 1), torch.stack(K, 1)


def plain_vector_pass(G, A, Bm, L, dinv, K, rx, vm):
    """The affine LQR pass against stored factors: backward g = rx_k +
    G' vm_k + B_k' sv, kff_k = M_k^-1 g, sv <- A_k' sv - K_k' g; forward
    du_k = -K_k dx - kff_k, dx <- A_k dx + B_k du_k.  Returns du (B, H, nu)
    and gdu (B, H, m) = G du_k."""
    del dinv                    # the triangular solves use L's diagonal
    A, Bm = _widened(G, A, Bm)
    H = A.shape[1]
    sv = torch.zeros_like(A[:, 0, 0])
    kff = [None] * H
    for k in reversed(range(H)):
        g = rx[:, k] + vm[:, k] @ G + _mtv(Bm[:, k], sv)
        kff[k] = spd_solve(L[:, k], g)
        sv = _mtv(A[:, k], sv) - _mtv(K[:, k], g)
    dx, du = torch.zeros_like(sv), []
    for k in range(H):
        d = -_mv(K[:, k], dx) - kff[k]
        dx = _mv(A[:, k], dx) + _mv(Bm[:, k], d)
        du.append(d)
    du = torch.stack(du, 1)
    return du, du @ G.T


def _fused_dims(A, Bm, G):
    B, H, nx = A.shape[:3]
    nu, m = Bm.shape[-1], G.shape[0]
    nx_max, nu_max, m_max, h_max = _kernels.fused_riccati_limits()
    if nx > nx_max or nu > nu_max or m > m_max:
        raise ValueError(f"fused Riccati kernels support nx<={nx_max}, "
                         f"nu<={nu_max}, m<={m_max}; got nx={nx}, nu={nu}, "
                         f"m={m}")
    return B, H, nx, nu, m, h_max


def _ab_args(name, A, Bm):
    """(A, Bm, store) for the kernels: both float32, made contiguous (store
    ""), or both bfloat16 in bf16_knots' layout, copied into it where they
    are not (store "_bf16", the bf16 kernels' entry points)."""
    if (A.dtype == torch.bfloat16) != (Bm.dtype == torch.bfloat16):
        raise TypeError(f"{name}: A and Bm are both bfloat16 or neither, "
                        f"got {A.dtype} and {Bm.dtype}")
    if A.dtype != torch.bfloat16:
        return (*_kernel_args(name, A, Bm), "")
    for t in (A, Bm):
        if t.device.type != "cuda":
            raise ValueError(f"{name}: the fused Riccati kernels take CUDA "
                             f"tensors, got {t.device}")
    A, Bm = (t if _in_bf16_layout(t) else bf16_knots(t) for t in (A, Bm))
    return A, Bm, "_bf16"


def _kernel_args(name, *tensors):
    """Check CUDA float32 and make contiguous: the kernels' inputs."""
    out = []
    for t in tensors:
        if t.device.type != "cuda":
            raise ValueError(f"{name}: the fused Riccati kernels take CUDA "
                             f"tensors, got {t.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: the fused Riccati kernels run in "
                            f"float32, got {t.dtype}")
        out.append(t.contiguous())
    return out


def _launch_fused(name, fn, tensors, outs, dims, device):
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(*(t.data_ptr() for t in tensors + outs), *dims,
                 ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")


def _route(name, t):
    kind = t.device.type
    if kind not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {t.device}")
    return kind == "cuda"


def fused_rollout(G, R, Q, A, Bm, q, u, zm, x0):
    """plain_rollout's contract; one kernel launch on CUDA tensors (the
    bf16 kernel for bfloat16 A and Bm)."""
    if not _route("fused_rollout", x0):
        return plain_rollout(G, R, Q, A, Bm, q, u, zm, x0)
    A, Bm, store = _ab_args("fused_rollout", A, Bm)
    G, R, Q, q, u, zm, x0 = _kernel_args("fused_rollout", G, R, Q, q, u, zm,
                                         x0)
    B, H, nx, nu, m, h_max = _fused_dims(A, Bm, G)
    if H > h_max:
        raise ValueError(f"fused_rollout: the kernel keeps x in shared "
                         f"memory and takes H <= {h_max}, got H={H}")
    opts = dict(dtype=torch.float32, device=x0.device)
    outs = [torch.empty((B, H, nx), **opts), torch.empty((B, H, nu), **opts),
            torch.empty((B, H, m), **opts)]
    _launch_fused("fused_rollout", getattr(
        _kernels.fused_riccati(), f"fused_rollout{store}_launch"),
        [G, R, Q, A, Bm, q, u, zm, x0], outs, (B, H, nx, nu, m), x0.device)
    fused_rollout.launches += 1
    return tuple(outs)


def fused_factor(G, R, Q, A, Bm, W):
    """plain_factor_pass's contract; one kernel launch on CUDA tensors (the
    bf16 kernel for bfloat16 A and Bm)."""
    if not _route("fused_factor", A):
        return plain_factor_pass(G, R, Q, A, Bm, W)
    A, Bm, store = _ab_args("fused_factor", A, Bm)
    G, R, Q, W = _kernel_args("fused_factor", G, R, Q, W)
    B, H, nx, nu, m, _ = _fused_dims(A, Bm, G)
    opts = dict(dtype=torch.float32, device=A.device)
    outs = [torch.empty((B, H, nu, nu), **opts),
            torch.empty((B, H, nu), **opts),
            torch.empty((B, H, nu, nx), **opts)]
    _launch_fused("fused_factor", getattr(
        _kernels.fused_riccati(), f"fused_factor{store}_launch"),
        [G, R, Q, A, Bm, W], outs, (B, H, nx, nu, m), A.device)
    fused_factor.launches += 1
    return tuple(outs)


def fused_vector(G, A, Bm, L, dinv, K, rx, vm):
    """plain_vector_pass's contract; one kernel launch on CUDA tensors (the
    bf16 kernel for bfloat16 A and Bm)."""
    if not _route("fused_vector", A):
        return plain_vector_pass(G, A, Bm, L, dinv, K, rx, vm)
    A, Bm, store = _ab_args("fused_vector", A, Bm)
    G, L, dinv, K, rx, vm = _kernel_args("fused_vector", G, L, dinv, K, rx,
                                         vm)
    B, H, nx, nu, m, h_max = _fused_dims(A, Bm, G)
    if H > h_max:
        raise ValueError(f"fused_vector: the kernel keeps kff in shared "
                         f"memory and takes H <= {h_max}, got H={H}")
    opts = dict(dtype=torch.float32, device=A.device)
    outs = [torch.empty((B, H, nu), **opts), torch.empty((B, H, m), **opts)]
    _launch_fused("fused_vector", getattr(
        _kernels.fused_riccati(), f"fused_vector{store}_launch"),
        [G, A, Bm, L, dinv, K, rx, vm], outs, (B, H, nx, nu, m), A.device)
    fused_vector.launches += 1
    return tuple(outs)


# kernel launches made by this process (chip_smoke.py reads them)
fused_rollout.launches = 0
fused_factor.launches = 0
fused_vector.launches = 0


# ---------------------------------------------------------------------------
# the fused IPM: the Mehrotra loop around the three passes
# ---------------------------------------------------------------------------

def solve_stage_qp_fused(qp: StageQP, cfg: SolverConfig = SolverConfig(),
                         warm: WarmStart | None = None) -> StageSolution:
    """Same contract and outputs as ops.riccati.solve_stage_qp for a StageQP
    without state rows or accel rows; with cfg.stage_bf16, those of the
    scan on A and B rounded to bfloat16, the passes reading them at
    bf16."""
    if qp.Cx is not None or qp.acc_rhs is not None:
        raise ValueError(
            "the fused Riccati IPM has no state rows (Cx) or accel rows "
            "(acc_rhs); use solve_stage_qp_resident (planner."
            "effective_backend reroutes base_box / base_acc plans)")
    if qp.x0.device.type not in ("cpu", "cuda"):
        raise ValueError(f"solve_stage_qp_fused: unsupported device "
                         f"{qp.x0.device}")
    with highest_precision():
        return _fused_impl(qp, cfg, warm)


def _fused_impl(qp: StageQP, cfg: SolverConfig,
                warm: WarmStart | None) -> StageSolution:
    dt, dev = qp.x0.dtype, qp.x0.device
    batch = qp.x0.shape[:-1]
    nb = math.prod(batch)
    H, nx, nu, m = qp.A.shape[-3], qp.A.shape[-1], qp.B.shape[-1], \
        qp.h.shape[-1]

    def flat(v, rows):
        """(batch..) + rows -> (nb,) + rows, contiguous."""
        v = torch.broadcast_to(v.to(device=dev, dtype=dt), batch + rows)
        return v.reshape((nb,) + rows).contiguous()

    A, Bm = flat(qp.A, (H, nx, nx)), flat(qp.B, (H, nx, nu))
    if cfg.stage_bf16:
        # cast once a plan: the kernels read bf16 A, B in their layout; the
        # plain passes (CPU) take them rounded, in the working dtype
        A, Bm = (bf16_knots(v) if dev.type == "cuda"
                 else v.to(torch.bfloat16).to(dt) for v in (A, Bm))
    q, mask = flat(qp.qlin, (H, nx)), flat(qp.mask, (H, m))
    h = torch.where(mask > 0, flat(qp.h, (H, m)), torch.ones_like(mask))
    x0 = flat(qp.x0, (nx,))
    G, R, Q = (v.to(dt).contiguous() for v in (qp.G, qp.R, qp.Q))
    # reg goes into the factor pass's R only; the stationarity residual
    # uses the unregularised R, as in the scan
    rmat = R + cfg.static_reg * torch.eye(nu, dtype=dt, device=dev)
    m_eff = torch.clamp(mask.sum(dim=(1, 2)), min=1.0)
    ms, frac = cfg.min_slack, cfg.frac_to_boundary

    # ---- initial point ----------------------------------------------------
    u = torch.zeros((nb, H, nu), dtype=dt, device=dev)
    r0 = -h
    shift = torch.clamp(r0.amax(dim=(1, 2), keepdim=True), min=0.0) + 1.0
    s = -r0 + shift
    z = torch.clamp(r0, min=0.0) + 1.0
    if warm is not None:
        v = flat(warm.valid, ())[:, None, None] > 0.5
        floor = constant(cfg.warm_floor, dt, dev)
        u = torch.where(v, flat(warm.u, (H, nu)), u)
        z = torch.where(v, torch.maximum(flat(warm.z, (H, m)), floor), z)
        s = torch.where(v, torch.maximum(flat(warm.s, (H, m)), floor), s)
    qnorm = 1.0 + torch.sqrt((q * q).sum(dim=(1, 2)))
    hnorm = 1.0 + torch.sqrt((h * h).sum(dim=(1, 2)))

    def measure(u, z, s):
        x, rx, gu = fused_rollout(G, R, Q, A, Bm, q, u, mask * z, x0)
        rz = mask * gu + s - h
        mu = (s * z * mask).sum(dim=(1, 2)) / m_eff
        res = torch.maximum(
            torch.sqrt((rx * rx).sum(dim=(1, 2))) / qnorm,
            torch.sqrt(((rz * mask) ** 2).sum(dim=(1, 2))) / hnorm)
        return x, rx, rz, mu, res

    def ratio(v, dv):
        neg = (dv < 0) & (mask > 0)
        r = torch.where(neg, -v / torch.where(neg, dv, -torch.ones_like(dv)),
                        torch.full_like(v, float("inf")))
        return r.amin(dim=(1, 2))

    def steplen(s, ds, z, dz, f):
        return torch.clamp(f * torch.minimum(ratio(s, ds), ratio(z, dz)),
                           max=1.0)

    done = torch.zeros(nb, dtype=torch.bool, device=dev)
    it_conv = torch.full((nb,), cfg.iters, dtype=torch.int32, device=dev)
    for it in range(cfg.iters):
        x, rx, rz, mu, res = measure(u, z, s)
        now = (res < cfg.reltol) & (mu < cfg.abstol)
        it_conv = it_conv.masked_fill(now & ~done, it)
        done = done | now

        s_safe = torch.clamp(s, min=ms)
        W = torch.clamp(torch.clamp(z, min=ms) / s_safe, 0.0, cfg.w_clip)
        L, D, K = fused_factor(G, rmat, Q, A, Bm, mask * W)

        def newton(rc):
            vm = mask * (W * rz + rc / s_safe)
            du, gdu = fused_vector(G, A, Bm, L, D, K, rx, vm)
            ds = -rz - mask * gdu
            return du, (rc - z * ds) / s_safe, ds

        du_a, dz_a, ds_a = newton(-s * z)
        a_a = steplen(s, ds_a, z, dz_a, 1.0)[:, None, None]
        mu_aff = ((s + a_a * ds_a) * (z + a_a * dz_a)
                  * mask).sum(dim=(1, 2)) / m_eff
        sigma = torch.clamp(mu_aff / torch.clamp(mu, min=ms), 0.0,
                            1.0) ** cfg.sigma_pow
        rc = -(s * z + ds_a * dz_a - (sigma * mu)[:, None, None])
        du, dz, ds = newton(rc)

        a = steplen(s, ds, z, dz, frac)
        a = torch.where(done, torch.zeros_like(a), a)[:, None, None]
        u = u + a * du
        z = torch.clamp(z + a * dz, min=ms)
        s = torch.clamp(s + a * ds, min=ms)

    x, _, _, mu, res = measure(u, z, s)
    conv = done | ((res < cfg.reltol) & (mu < cfg.abstol))

    def unflat(v):
        return v.reshape(batch + v.shape[1:])

    return finalize(unflat(u), unflat(x), unflat(z), unflat(s), unflat(conv),
                    unflat(it_conv), unflat(mu), unflat(res))
