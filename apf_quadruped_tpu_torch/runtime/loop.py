"""The closed-loop controller, batched over scenarios.

Port of apf_quadruped_tpu/runtime/loop.py.  One replan cycle:
  1. robustness EWMA update + APF navigation (+ foothold selection);
  2. one convex MPC solve over the gait horizon (planner.plan, the resident
     IPM kernel on the card), warm-started from the previous cycle;
  3. 400 Hz tracking: gait-phase query -> swing spline refs -> whole-body
     QP -> torques -> physics step, with the friction-cone margin integral
     and the momentum observer updated every tick.

Every LoopState field carries the scenario axis in front.  The JAX module
compiles a cycle (`run_cycle`, jitted) that scans a single-scenario tick
(`lax.scan`) and vmaps it; here the cycle is batched and split in three:
the head (`_cycle_head`: navigation, foothold, references, the plan, the
warm-start stash), the ticks (`_scan_ticks` over the batched `_tick`) and
the tail (`_cycle_tail`: the metrics and the next LoopState).  On the card
the head and the tail are one replay each of their captured CUDA graphs
(runtime/graph.call; the plan is captured inside the head's) and the
ticks replay a CUDA graph of one tick once a tick (runtime/graph.scan);
each graph is captured at the first cycle of a configuration and shape
and runs the same kernels on the same data as the eager code, bit for
bit.  The CPU runs the eager head, ticks and tail; nothing in them reads
a value back to the host.  The cycle loop is a Python loop.
Gait modes (GaitConfig.mode): "trot"
alternates trot pair A / pair B per cycle; "crawl" walks one leg at a time;
"adaptive" switches to the crawl combo per lane from the robustness EWMA;
the named strides of gait.NAMED_MODE_FLAGS run one flag every cycle.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import numpy as np
import torch

from .. import apf, foothold, gait, planner, swing, wbc
from .._device import constant, resolve_device
from .._precision import highest_precision
from ..config import EngineConfig
from ..models import rbd, srb
from ..ops.riccati import WarmStart
from ..ops.rotations import rot_to_rpy
from ..sim import disturbance, physics
from ..sim import terrain as terrain_mod
from . import graph, observer, profiling


class LoopState(NamedTuple):
    sim: physics.SimState
    apf: apf.ApfState
    cycle_idx: torch.Tensor    # (B,) int32
    crawling: torch.Tensor     # (B,) bool — adaptive-mode gait memory
    # the previous cycle's MPC solution, the next solve's warm start,
    # leg-permuted at store time for the mirrored trot pair
    warm_u: torch.Tensor       # (B, H, 12) world-frame knot forces
    warm_z: torch.Tensor       # (B, H, 24 [+12]) duals
    warm_s: torch.Tensor       # (B, H, 24 [+12]) slacks
    warm_valid: torch.Tensor   # (B,) bool
    # (B,) int32 — the gait flag the stored solution is valid for; a cycle
    # with another flag starts cold (a stale warm start across a gait
    # switch is worse than cold)
    warm_flag: torch.Tensor
    obs: observer.ObserverState


class CycleMetrics(NamedTuple):
    """Per-cycle observability, each (B, ...)."""

    com: torch.Tensor          # (B, 3) CoM at cycle end
    com_err: torch.Tensor      # |com - com_des| at cycle end (xy)
    rob_mean: torch.Tensor     # mean robustness index
    fake_crawl: torch.Tensor   # bool
    qp_converged: torch.Tensor  # fraction of converged WBC solves
    mpc_converged: torch.Tensor  # bool
    mpc_iters: torch.Tensor    # IPM iterations of the cycle's MPC solve
    crawling: torch.Tensor     # bool — crawl combo engaged this cycle
    slip_ticks: torch.Tensor   # fraction of ticks with any foot slipping
    tau_max: torch.Tensor      # peak |tau| over the cycle
    qdd_max: torch.Tensor      # peak |joint accel| commanded
    foot_mu: torch.Tensor      # mean terrain mu under the step targets
    track_err: torch.Tensor    # mean CoM tracking error during the cycle
    early_td_frac: torch.Tensor  # mean share of early-touch-down legs
    wrench_est: torch.Tensor   # (B, 6) external-wrench estimate at the end
    wrench_peak: torch.Tensor  # peak estimated force magnitude
    # share of the cycle's loaded foot-ticks (in contact, normal force over
    # physics.LOADED_N) on ground raised or tilted (physics.ContactInfo.
    # on_feature), on a height map; None on flat ground, where the cycle
    # computes nothing for it.  The JAX package has no such field
    ground_feet: Optional[torch.Tensor] = None


def _gait_schedule(cfg: EngineConfig, st: LoopState, ast: apf.ApfState):
    """(gait_flag (B,) int32, crawling (B,) bool, cycle seconds)."""
    idx = st.cycle_idx
    mode = cfg.gait.mode

    def const(flag):
        return torch.full_like(idx, flag)

    if mode == "crawl":
        return const(4), torch.ones_like(st.crawling), cfg.gait.crawl_cycle
    if mode in gait.NAMED_MODE_FLAGS:
        return (const(gait.NAMED_MODE_FLAGS[mode]),
                torch.zeros_like(st.crawling), cfg.gait.fixed_cycle)
    if mode == "adaptive":
        # hysteresis: enter the crawl combo below crawl_enter_threshold,
        # return to the full trot cycle above crawl_exit_threshold
        rob_mean = ast.rob_foot.mean(dim=-1)
        crawling = torch.where(st.crawling,
                               rob_mean <= cfg.apf.crawl_exit_threshold,
                               rob_mean < cfg.apf.crawl_enter_threshold)
        return (torch.where(crawling, const(4), const(15)), crawling,
                cfg.gait.crawl_cycle)
    if mode != "trot":
        raise ValueError(f"unknown gait mode {mode!r}")
    return (torch.where(idx % 2 == 0, const(1), const(2)),
            torch.zeros_like(st.crawling), cfg.gait.trot_cycle)


def _take(v: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """v (B, K, ..) at per-lane index k (B,) -> (B, ..)."""
    return v[torch.arange(v.shape[0], device=v.device), k]


class _CycleInputs(NamedTuple):
    """What the tick reads of its cycle (each (B, ..) unless noted)."""

    gait_flag: torch.Tensor      # (B,) int32
    cycle: torch.Tensor          # (B,) cycle seconds
    crawling: torch.Tensor       # (B,) bool
    liftoff_feet: torch.Tensor   # (B, 4, 3) feet at the cycle's start
    step_targets3: torch.Tensor  # (B, 4, 3)
    states_knots: torch.Tensor   # (B, H + 1, 13) plan states from t = 0
    forces: torch.Tensor         # (B, H, 4, 3) plan forces
    terr: terrain_mod.Terrain
    dist_sched: torch.Tensor     # (B, n_events, 8)
    g_vec: torch.Tensor          # (3,) gravity
    zeros3: torch.Tensor         # (B, 3)
    knot_ratio: float            # sim.dt / mpc.dt in the working precision


# the tick's trace values, in the order _tick returns them; on a height
# map followed by TRACE_GROUND: the loaded feet, and those of them on
# raised or tilted ground, counted a tick
TRACE = ("conv", "slip", "taumax", "track", "td", "qdd", "wpeak")
TRACE_GROUND = ("loaded", "on_feature")


def _tick(cfg: EngineConfig, cyc: _CycleInputs, carry, k: torch.Tensor):
    """One 400 Hz tracking tick for the batch, the JAX module's
    `tick(carry, k)`: references (_tick_refs) -> whole-body QP -> physics
    step -> margin integral, observer and trace values (_tick_tail).
    carry = (SimState, ApfState, td_flag (B, 4) bool, td_pos (B, 4, 3),
    prev_contact (B, 4) bool, ObserverState); k (1,) int64 on the
    tensors' device.  Returns (carry, the trace values of
    `_trace_names(cyc.terr)`, each (B,))."""
    sim_st, ast, _, _, _, obs = carry
    profiling.mark("tick.refs", k)
    wst, ref, td_flag, td_pos = _tick_refs(cfg, cyc, carry, k)
    out = wbc.solve(cfg, wst, ref)
    profiling.mark("physics", k)
    fd, ff = disturbance.eval_links(cyc.dist_sched, sim_st.t)
    sim_st, cinfo = physics.step(cfg, sim_st, out.tau, cyc.terr, f_dist=fd,
                                 f_feet=ff)
    profiling.mark("tick.tail", k)
    return _tick_tail(cfg, (sim_st, ast, td_flag, td_pos, cinfo.in_contact,
                            obs), out, cinfo, ref)


def _tick_refs(cfg: EngineConfig, cyc: _CycleInputs, carry,
               k: torch.Tensor):
    """The tick's references: gait phase -> swing refs (early touch-down)
    -> MPC refs.  Returns (WbcState, WbcRefs, td_flag, td_pos)."""
    sim_st, _, td_flag, td_pos, prev_contact, _ = carry
    dtype = sim_st.q.dtype
    B = sim_st.q.shape[0]
    robot = cfg.robot
    terr = cyc.terr
    kf = k.to(dtype)
    t = (kf * cfg.sim.dt).expand(B)
    info = gait.phase_info(cyc.gait_flag, t, cyc.cycle, dtype=dtype)
    contact = info["contact"]
    dur = torch.clamp(info["t_end"] - info["t_start"], min=1e-3)
    tau_ph = (t[..., None] - info["t_start"]) / dur
    sw_pos, sw_vel, sw_acc = swing.swing_ref(
        cyc.liftoff_feet, cyc.step_targets3, cfg.mpc.swing_height, tau_ph,
        dur)

    if cfg.gait.early_td or terr.h_map is not None:
        feet_now = rbd.foot_positions_world(robot, sim_st.p_base,
                                            sim_st.R_wb, sim_st.q)
    if cfg.gait.early_td:
        # early touch-down: a swing foot with measured contact in the
        # last early_td_window of its swing latches td_flag, freezes
        # its swing ref at the touch-down point and counts as stance
        near_end = t[..., None] > info["t_end"] - cfg.gait.early_td_window
        is_swing = contact < 0.5
        touched = prev_contact & is_swing & near_end
        newly = touched & ~td_flag
        td_pos = torch.where(newly[..., None], feet_now, td_pos)
        td_flag = (td_flag | touched) & is_swing
        latched = td_flag[..., None]
        sw_pos = torch.where(latched, td_pos, sw_pos)
        sw_vel = torch.where(latched, torch.zeros_like(sw_vel), sw_vel)
        sw_acc = torch.where(latched, torch.zeros_like(sw_acc), sw_acc)
        contact = torch.maximum(contact, td_flag.to(dtype))

    # MPC refs: first-order hold of the state between knots, zero-order
    # hold of the forces
    tk = (kf * cyc.knot_ratio).expand(B)
    k0 = torch.clamp(tk.to(torch.int32), 0, cfg.mpc.horizon - 1).to(
        torch.int64)
    wk = torch.clamp(tk - k0.to(dtype), 0.0, 1.0)[..., None]
    xk = ((1.0 - wk) * _take(cyc.states_knots, k0)
          + wk * _take(cyc.states_knots, k0 + 1))
    com_acc = _take(cyc.forces, k0).sum(dim=-2) / robot.mass + cyc.g_vec

    ref = wbc.WbcRefs(com_pos=xk[..., 3:6], com_vel=xk[..., 9:12],
                      com_acc=com_acc, rpy=xk[..., 0:3],
                      omega=xk[..., 6:9], omega_dot=cyc.zeros3,
                      swing_pos=sw_pos, swing_vel=sw_vel, swing_acc=sw_acc)
    wst = wbc.WbcState(p_base=sim_st.p_base, R_wb=sim_st.R_wb, q=sim_st.q,
                       u=sim_st.u, contact=contact, crawl=cyc.crawling)
    if terr.h_map is not None:
        profiling.mark("ground", k)
        wst = wst._replace(cone_rot=terrain_mod.cone_basis(
            terr, feet_now[..., 0:2]))
    return wst, ref, td_flag, td_pos


def _tick_tail(cfg: EngineConfig, carry, out, cinfo, ref):
    """After the physics step: the margin integral and the observer, the
    new carry and the tick's TRACE values."""
    sim_st, ast, td_flag, td_pos, in_contact, obs = carry
    ast = apf.accumulate_margin(cfg.apf, ast, cinfo.forces, cfg.sim.dt)
    obs = observer.update_from_dyn(
        obs, out.M, out.h_bias, out.Jc, sim_st.u, cinfo.forces_avg,
        cfg.sim.dt, cfg.observer.gain,
        mdot_u=observer.mdot_u(cfg, sim_st.R_wb, sim_st.q, sim_st.u))
    com_now = rbd.com_position(cfg.robot, sim_st.p_base, sim_st.R_wb,
                               sim_st.q)
    row = (out.sol.converged, cinfo.slipping.any(dim=-1),
           out.tau.abs().amax(dim=-1),
           torch.linalg.vector_norm(com_now - ref.com_pos, dim=-1),
           td_flag.to(sim_st.q.dtype).mean(dim=-1),
           out.udot[..., 6:18].abs().amax(dim=-1),
           torch.linalg.vector_norm(obs.w[..., 0:3], dim=-1))
    if cinfo.on_feature is not None:
        row += (cinfo.loaded.sum(dim=-1).to(sim_st.q.dtype),
                cinfo.on_feature.sum(dim=-1).to(sim_st.q.dtype))
    return (sim_st, ast, td_flag, td_pos, in_contact, obs), row


def _trace_names(terr: terrain_mod.Terrain) -> tuple:
    """The names of a tick's trace values on `terr`."""
    return TRACE + (TRACE_GROUND if terr.h_map is not None else ())


def _trace_buffers(B: int, n_ticks: int, dtype, device, names=TRACE):
    """(B, n_ticks) buffers of the trace values `names`: the stacked
    outputs of the JAX module's scan (and the ground counts, on a height
    map)."""
    return tuple(torch.empty((B, n_ticks), device=device,
                             dtype=torch.bool if name in ("conv", "slip")
                             else dtype)
                 for name in names)


def _step(cfg: EngineConfig, cyc: _CycleInputs, carry, k: torch.Tensor,
          trace):
    """_tick, its trace values written into `trace` at column k; with
    profiling.marks on, a stage mark at each of the tick's stages and at
    its end."""
    carry, row = _tick(cfg, cyc, carry, k)
    for buf, v in zip(trace, row):
        buf.index_copy_(1, k, v.unsqueeze(1))
    profiling.mark("tick.end", k)
    return carry


def _scan_ticks_eager(cfg: EngineConfig, cyc: _CycleInputs, carry,
                      n_ticks: int):
    """n_ticks eager ticks: (carry, the TRACE buffers (B, n_ticks))."""
    q = carry[0].q
    trace = _trace_buffers(q.shape[0], n_ticks, q.dtype, q.device,
                           _trace_names(cyc.terr))
    k = torch.zeros(1, dtype=torch.int64, device=q.device)
    for _ in range(n_ticks):
        carry = _step(cfg, cyc, carry, k, trace)
        k += 1
    return carry, trace


def _scan_ticks(cfg: EngineConfig, cyc: _CycleInputs, carry, n_ticks: int):
    """The JAX module's `lax.scan` over a cycle's ticks: on the card
    replays of a CUDA graph of one tick (runtime/graph.py), on the CPU the
    eager ticks.  Returns (carry, the TRACE buffers (B, n_ticks))."""
    q = carry[0].q
    if q.device.type != "cuda":
        return _scan_ticks_eager(cfg, cyc, carry, n_ticks)
    trace = _trace_buffers(q.shape[0], n_ticks, q.dtype, q.device,
                           _trace_names(cyc.terr))
    carry = graph.scan(("tick", cfg, n_ticks), functools.partial(_step, cfg),
                       cyc, carry, trace, n_ticks)
    return carry, trace


class _TailInputs(NamedTuple):
    """What a cycle's tail reads of its head (each (B, ..))."""

    cycle_idx: torch.Tensor      # int32, the next cycle's index
    crawling: torch.Tensor       # bool
    warm_next: tuple             # the next warm_u, z, s, valid, flag
    com_des: torch.Tensor        # (B, 2)
    rob_mean: torch.Tensor
    fake_crawl: torch.Tensor     # bool
    mpc_converged: torch.Tensor  # bool
    mpc_iters: torch.Tensor      # int32
    foot_mu: torch.Tensor


class _CycleHead(NamedTuple):
    """What a cycle's head hands its ticks and its tail."""

    cyc: _CycleInputs
    carry: tuple               # the ticks' initial carry
    n_ticks: int
    tail: _TailInputs


def run_cycle(cfg: EngineConfig, st: LoopState, terr: terrain_mod.Terrain,
              target_xy: torch.Tensor,
              dist_sched: torch.Tensor) -> tuple[LoopState, CycleMetrics]:
    """One replan cycle for every scenario of the batch: navigate, plan,
    track.  terr holds (B, res, res) grids, target_xy (B, 2), dist_sched
    (B, n_events, 8).  Runs with TF32 off throughout.  While a profiler
    records, a span `apf: loop.run_cycle` holds `loop.cycle_head`,
    `loop.scan_ticks` and `loop.cycle_tail`."""
    with highest_precision(), profiling.trace("loop.run_cycle"):
        with profiling.trace("loop.cycle_head"):
            head = _cycle_head(cfg, st, terr, target_xy, dist_sched)
        with profiling.trace("loop.scan_ticks"):
            carry, trace = _scan_ticks(cfg, head.cyc, head.carry,
                                       head.n_ticks)
        with profiling.trace("loop.cycle_tail"):
            return _cycle_tail(cfg, head.tail, carry, trace)


def _cycle_head(cfg: EngineConfig, st: LoopState,
                terr: terrain_mod.Terrain, target_xy: torch.Tensor,
                dist_sched: torch.Tensor) -> _CycleHead:
    """The cycle before its ticks: on the card a replay of its captured
    CUDA graph (runtime/graph.call, the plan captured inside it), on the
    CPU the eager head."""
    if st.sim.q.device.type != "cuda":
        return _cycle_head_eager(cfg, st, terr, target_xy, dist_sched)
    return graph.call(("cycle head", cfg),
                      lambda args: _cycle_head_eager(cfg, *args),
                      (st, terr, target_xy, dist_sched))


def _cycle_head_eager(cfg: EngineConfig, st: LoopState,
                      terr: terrain_mod.Terrain, target_xy: torch.Tensor,
                      dist_sched: torch.Tensor) -> _CycleHead:
    """Navigation, foothold, references, the plan and the warm-start stash,
    op by op."""
    sim0 = st.sim
    dtype, dev = sim0.q.dtype, sim0.q.device
    B = sim0.q.shape[0]
    robot = cfg.robot
    Hh = cfg.mpc.horizon

    # ---- 1. navigation -------------------------------------------------
    ast = apf.update_robustness(cfg.apf, st.apf)
    feet_w = rbd.foot_positions_world(robot, sim0.p_base, sim0.R_wb, sim0.q)
    com_w = rbd.com_position(robot, sim0.p_base, sim0.R_wb, sim0.q)
    nav = apf.navigate(cfg.apf, ast, feet_w[..., 0:2], com_w[..., 0:2],
                       target_xy, robot=robot)
    gait_flag, crawling, cycle_s = _gait_schedule(cfg, st, ast)
    cycle = torch.full((B,), cycle_s, dtype=dtype, device=dev)
    n_ticks = int(round(cycle_s / cfg.sim.dt))

    step_xy = nav.step_targets
    if cfg.foothold.enabled:
        step_xy = foothold.optimize(cfg.foothold, robot, terr, step_xy,
                                    nav.com_des)
    # foothold and CoM heights follow the terrain
    com_des3 = torch.cat([nav.com_des, (terrain_mod.sample_height(
        terr, nav.com_des) + robot.com_height)[..., None]], dim=-1)
    step_targets3 = torch.cat([step_xy, (terrain_mod.sample_height(
        terr, step_xy) + robot.foot_radius)[..., None]], dim=-1)

    # ---- 2. MPC plan over the cycle ------------------------------------
    zero_t = torch.zeros((B,), dtype=dtype, device=dev)
    contacts_h = gait.horizon_contacts(gait_flag, zero_t, cfg.mpc.dt, Hh,
                                       cycle, dtype=dtype)
    feet_sched = planner.foothold_schedule(feet_w, step_targets3, contacts_h)
    cone_rot = (terrain_mod.cone_basis(terr, feet_sched[..., 0:2])
                if terr.h_map is not None else None)
    rpy_now = rot_to_rpy(sim0.R_wb)
    com0 = torch.cat([com_w[..., 0:2], (terrain_mod.sample_height(
        terr, com_w[..., 0:2]) + robot.com_height)[..., None]], dim=-1)
    x_ref = planner.reference_trajectory(cfg, rpy_now, com0, com_des3,
                                         rpy_now[..., 2], cycle)
    v_com = (rbd.com_jacobian(robot, sim0.R_wb, sim0.q)
             @ sim0.u.unsqueeze(-1)).squeeze(-1)
    x0 = srb.pack_state(rpy_now, com_w, sim0.u[..., 3:6], v_com)
    warm_on = (planner.effective_backend(cfg, dev).startswith("riccati")
               and cfg.mpc.warm_start)
    warm = None
    if warm_on:
        warm = WarmStart(u=st.warm_u, z=st.warm_z, s=st.warm_s,
                         valid=st.warm_valid & (st.warm_flag == gait_flag))
    plan = planner.plan(cfg, x0, planner.MpcRefs(
        contacts=contacts_h, feet_w=feet_sched, x_ref=x_ref,
        yaw_ref=rpy_now[..., 2], cone_rot=cone_rot), warm=warm)

    # stash this solve for the next cycle's warm start: consecutive trot
    # cycles mirror the swing pair (flags 1 <-> 2), so the stored solution
    # is leg-permuted BR<->BL, FL<->FR; the other modes reuse one schedule
    if warm_on:
        if cfg.gait.mode == "trot":
            def legs(v):
                return v.index_select(2, constant((1, 0, 3, 2),
                                                  torch.int64, dev))
            flag_for = 3 - gait_flag
        else:
            def legs(v):
                return v
            flag_for = gait_flag
        u_next = legs(plan.forces).reshape(B, Hh, 12)

        def permute_rows(v):
            # the first 24 rows are the per-leg pyramid (4 legs x 6) and
            # move with the legs; extra (base_acc) rows are leg-agnostic
            v = v.reshape(B, Hh, -1)
            pyr = legs(v[..., :24].reshape(B, Hh, 4, 6))
            return torch.cat([pyr.reshape(B, Hh, 24), v[..., 24:]], dim=-1)
        warm_next = (u_next, permute_rows(plan.sol.z),
                     permute_rows(plan.sol.s),
                     torch.ones_like(st.warm_valid), flag_for)
    else:
        warm_next = (st.warm_u, st.warm_z, st.warm_s, st.warm_valid,
                     st.warm_flag)

    # ---- 3. the ticks' inputs ------------------------------------------
    # knot coordinate of tick k = k sim.dt / mpc.dt, with the ratio folded
    # in the working precision: XLA folds the JAX module's t / mpc.dt so,
    # and on a knot boundary (k = 30 in float64, k = 50 in float32) the
    # truncation in the tick then picks the knot the JAX package picks
    np_dtype = np.float64 if dtype == torch.float64 else np.float32
    cyc = _CycleInputs(
        gait_flag=gait_flag, cycle=cycle, crawling=crawling,
        liftoff_feet=feet_w, step_targets3=step_targets3,
        # knot states including t = 0 for first-order-hold references
        states_knots=torch.cat([x0[:, None], plan.states], dim=1),
        forces=plan.forces, terr=terr, dist_sched=dist_sched,
        g_vec=constant((0.0, 0.0, -srb.GRAVITY), dtype, dev),
        zeros3=torch.zeros((B, 3), dtype=dtype, device=dev),
        knot_ratio=float(np_dtype(cfg.sim.dt)
                         * (np_dtype(1.0) / np_dtype(cfg.mpc.dt))))
    no_td = torch.zeros((B, 4), dtype=torch.bool, device=dev)
    return _CycleHead(
        cyc=cyc, carry=(sim0, ast, no_td, feet_w, no_td.clone(), st.obs),
        n_ticks=n_ticks, tail=_TailInputs(
            cycle_idx=st.cycle_idx + 1, crawling=crawling,
            warm_next=warm_next, com_des=nav.com_des,
            rob_mean=nav.rob_mean, fake_crawl=nav.fake_crawl,
            mpc_converged=plan.sol.converged,
            mpc_iters=plan.sol.iters.to(torch.int32),
            foot_mu=terrain_mod.sample_mu(terr, step_xy).mean(dim=-1)))


def _cycle_tail(cfg: EngineConfig, tail: _TailInputs, carry,
                trace) -> tuple[LoopState, CycleMetrics]:
    """The cycle after its ticks: on the card a replay of its captured
    CUDA graph (runtime/graph.call), on the CPU the eager tail."""
    if carry[0].q.device.type != "cuda":
        return _cycle_tail_eager(cfg, tail, carry, trace)
    return graph.call(("cycle tail", cfg),
                      lambda args: _cycle_tail_eager(cfg, *args),
                      (tail, carry, trace))


def _cycle_tail_eager(cfg: EngineConfig, tail: _TailInputs, carry,
                      trace) -> tuple[LoopState, CycleMetrics]:
    """The next LoopState and the cycle's metrics (reductions over the
    ticks' trace), op by op."""
    sim_st, ast, _, _, _, obs = carry
    tr = dict(zip(TRACE + TRACE_GROUND, trace))
    dtype = sim_st.q.dtype
    com_end = rbd.com_position(cfg.robot, sim_st.p_base, sim_st.R_wb,
                               sim_st.q)
    metrics = CycleMetrics(
        com=com_end,
        com_err=torch.linalg.vector_norm(com_end[..., 0:2] - tail.com_des,
                                         dim=-1),
        rob_mean=tail.rob_mean, fake_crawl=tail.fake_crawl,
        qp_converged=tr["conv"].to(dtype).mean(dim=-1),
        mpc_converged=tail.mpc_converged,
        mpc_iters=tail.mpc_iters,
        crawling=tail.crawling,
        slip_ticks=tr["slip"].to(dtype).mean(dim=-1),
        tau_max=tr["taumax"].amax(dim=-1),
        qdd_max=tr["qdd"].amax(dim=-1),
        foot_mu=tail.foot_mu,
        track_err=tr["track"].mean(dim=-1),
        early_td_frac=tr["td"].mean(dim=-1),
        wrench_est=obs.w, wrench_peak=tr["wpeak"].amax(dim=-1),
        ground_feet=(tr["on_feature"].sum(dim=-1)
                     / torch.clamp(tr["loaded"].sum(dim=-1), min=1.0)
                     if "on_feature" in tr else None))
    warm_next = tail.warm_next
    return LoopState(sim=sim_st, apf=ast, cycle_idx=tail.cycle_idx,
                     crawling=tail.crawling, warm_u=warm_next[0],
                     warm_z=warm_next[1], warm_s=warm_next[2],
                     warm_valid=warm_next[3], warm_flag=warm_next[4],
                     obs=obs), metrics


def run(cfg: EngineConfig, st: LoopState, terr: terrain_mod.Terrain,
        target_xy: torch.Tensor, dist_sched: torch.Tensor,
        n_cycles: int) -> tuple[LoopState, CycleMetrics]:
    """n_cycles replan cycles; metrics stacked (B, n_cycles, ...)."""
    per_cycle = []
    for _ in range(n_cycles):
        st, m = run_cycle(cfg, st, terr, target_xy, dist_sched)
        per_cycle.append(m)
    return st, join_metrics(per_cycle, lambda v: torch.stack(v, dim=1))


def join_metrics(parts, join) -> CycleMetrics:
    """CycleMetrics `parts` joined field by field, `join` given each
    field's tensors; a field the parts leave None (ground_feet on flat
    ground) stays None."""
    return CycleMetrics(*(None if v[0] is None else join(v)
                          for v in zip(*parts)))


def init(cfg: EngineConfig, batch: int = 1, xy=(0.0, 0.0), yaw: float = 0.0,
         dtype=torch.float32, device="cuda") -> LoopState:
    """`batch` identical LoopStates at rest at the spawn pose, on the card
    unless `device` says otherwise."""
    device = resolve_device(device)
    Hh = cfg.mpc.horizon
    nrow = 24 + (12 if cfg.mpc.base_acc else 0)   # pyramid (+ base_acc) rows
    b = (batch,)
    opts = dict(dtype=dtype, device=device)
    zeros6 = torch.zeros(b + (6,), **opts)
    return LoopState(
        sim=physics.initial_state(cfg, xy, yaw, dtype, b, device),
        apf=apf.init_state(b, dtype, device),
        cycle_idx=torch.zeros(b, dtype=torch.int32, device=device),
        crawling=torch.full(b, cfg.gait.mode == "crawl", dtype=torch.bool,
                            device=device),
        warm_u=torch.zeros(b + (Hh, 12), **opts),
        warm_z=torch.zeros(b + (Hh, nrow), **opts),
        warm_s=torch.zeros(b + (Hh, nrow), **opts),
        warm_valid=torch.zeros(b, dtype=torch.bool, device=device),
        warm_flag=torch.zeros(b, dtype=torch.int32, device=device),
        # spawn is at rest, so the momentum offset p0 = (M u)[0:6] is 0
        obs=observer.ObserverState(y_int=zeros6, w=zeros6.clone(),
                                   p0=zeros6.clone()))
