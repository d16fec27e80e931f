"""Realtime traffic: one robot's controller, B=1, one caller in a closed
loop, every call fenced.  The calls repeat one warm replan and then
`wbc_per_plan` WBC ticks.

Traffic file keys: batch (1), pool (problems and states drawn once, used
in turn), wbc_per_plan, check_calls (calls of each kind the reference
checks, a seeded sample of the window's), trace_rounds (rounds of the
traced window).

Replans are `planner.plan` on bench.py's problems, each warm-started from
the previous replan's solution, as the loop does (the first of the window
from an invalid start, which is the cold one); ticks are `wbc.solve` on
the WBC latency benchmark's states.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from .. import common, gen, marked, spec
from .. import trace as trace_mod


def _t(v, dev, dtype=None):
    return torch.as_tensor(np.ascontiguousarray(v), device=dev, dtype=dtype)


class Runner:
    def __init__(self, run):
        from apf_quadruped_tpu_torch import planner, wbc
        from apf_quadruped_tpu_torch.ops.riccati import WarmStart
        from apf_quadruped_tpu_torch.runtime import graph
        self.run, self.planner, self.wbc, self.graph = run, planner, wbc, graph
        self.WarmStart = WarmStart
        self.tr = run.cell.traffic
        self.cfg = spec.program_config(run.cell.config)
        self.rcfg = spec.reference_config(run.cell.config)
        self.H = self.cfg.mpc.horizon

    # -- set-up ----------------------------------------------------------
    def traffic(self):
        run, dev = self.run, self.run.device
        n = self.tr["pool"]
        self.plan_host = gen.plan_problems(self.rcfg, n, gen.rng(run.seed, 2))
        self.wbc_host = gen.wbc_states(self.rcfg, n, gen.rng(run.seed, 3))
        self.plans = [self._plan_inputs(self.plan_host, [i], dev)
                      for i in range(n)]
        self.ticks = [self._wbc_inputs(self.wbc_host, [i], dev)
                      for i in range(n)]
        common.sync()

    def warm(self):
        """Three rounds, which capture the plan's and the WBC solve's
        graphs."""
        warm = self.cold()
        for i in range(3):
            out = self.plan_call(i, warm)
            warm = self.next_warm(out)
            self.wbc_call(i)
        common.sync()

    def _plan_inputs(self, h, idx, dev, dtype=None, mod=None):
        planner = self.planner if mod is None else mod
        x0 = _t(h["x0"][idx], dev, dtype)
        refs = planner.MpcRefs(**{k: _t(h[k][idx], dev, dtype) for k in
                                  ("contacts", "feet_w", "x_ref", "yaw_ref")})
        return x0, refs

    def _wbc_inputs(self, h, idx, dev, dtype=None, mod=None):
        wbc = self.wbc if mod is None else mod
        st = wbc.WbcState(**{k: _t(h[k][idx], dev, dtype if k != "crawl"
                                   else None)
                             for k in ("p_base", "R_wb", "q", "u", "contact",
                                       "crawl", "cone_rot")})
        ref = wbc.WbcRefs(**{k: _t(h[k][idx], dev, dtype) for k in
                             ("com_pos", "com_vel", "com_acc", "rpy", "omega",
                              "omega_dot", "swing_pos", "swing_vel",
                              "swing_acc")})
        return st, ref

    def cold(self):
        dev, H = self.run.device, self.H
        z = torch.zeros((1, H, 24), device=dev)
        return self.WarmStart(u=torch.zeros((1, H, 12), device=dev), z=z,
                              s=z.clone(),
                              valid=torch.zeros(1, dtype=torch.bool,
                                                device=dev))

    def next_warm(self, out):
        H = self.H
        return self.WarmStart(u=out.forces.reshape(1, H, 12),
                              z=out.sol.z.reshape(1, H, -1),
                              s=out.sol.s.reshape(1, H, -1),
                              valid=torch.ones(1, dtype=torch.bool,
                                               device=self.run.device))

    def plan_call(self, i, warm):
        x0, refs = self.plans[i % len(self.plans)]
        return self.planner.plan(self.cfg, x0, refs, warm)

    def wbc_call(self, i):
        st, ref = self.ticks[i % len(self.ticks)]
        return self.wbc.solve(self.cfg, st, ref)

    # -- the window -----------------------------------------------------
    def _rounds(self, seconds, events=False, keep=None):
        """Rounds of one replan and `wbc_per_plan` ticks until `seconds`
        have passed: {"plan": [(call ms, enqueue ms, device ms)],
        "wbc": [...]} (device ms with `events`, else None).  The calls
        whose output is not finite are counted in `self.bad`."""
        tr = self.tr
        lat = {"plan": [], "wbc": []}
        warm = self.cold()
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)] \
            if events else None
        ip = iw = 0
        bad = torch.zeros((), dtype=torch.int64, device=self.run.device)
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            calls = [("plan", ip)] + [("wbc", iw + k)
                                      for k in range(tr["wbc_per_plan"])]
            for kind, i in calls:
                if events:
                    ev[0].record()
                a = time.perf_counter()
                if kind == "plan":
                    warm_in = warm
                    out = self.plan_call(i, warm)
                else:
                    out = self.wbc_call(i)
                b = time.perf_counter()
                if events:
                    ev[1].record()
                common.sync(self.run.device)
                c = time.perf_counter()
                dev_ms = ev[0].elapsed_time(ev[1]) if events else None
                lat[kind].append(((c - a) * 1e3, (b - a) * 1e3, dev_ms))
                bad += ~torch.isfinite(out.forces if kind == "plan"
                                       else out.tau).all()
                if kind == "plan":
                    warm = self.next_warm(out)
                    if keep is not None:
                        keep["plan"].offer((i, warm_in, out))
                elif keep is not None:
                    keep["wbc"].offer((i, out))
            ip += 1
            iw += tr["wbc_per_plan"]
        self.bad = int(bad.item())
        return lat

    def window(self):
        run = self.run
        k = self.tr["check_calls"]
        self.keep = {"plan": common.Reservoir(k, gen.rng(run.seed, 11)),
                     "wbc": common.Reservoir(k, gen.rng(run.seed, 12))}
        graphs = len(self.graph.entries())
        self.lat = self._rounds(run.seconds, events=run.trace, keep=self.keep)
        self.captured_in_window = len(self.graph.entries()) - graphs
        wbc = np.array([x[0] for x in self.lat["wbc"]])
        plan = np.array([x[0] for x in self.lat["plan"]])
        self.out = {"wbc_calls": len(wbc), "plan_calls": len(plan)}
        return {"wbc_tick_p99_ms": float(np.percentile(wbc, 99)),
                "replan_p99_ms": float(np.percentile(plan, 99))}

    def counts(self):
        return self.out["wbc_calls"] + self.out["plan_calls"], self.bad

    # -- the traced window ------------------------------------------------
    def traced(self) -> dict:
        tr = trace_mod.profile(lambda: self._trace_rounds(
            self.tr["trace_rounds"]), self.graph._counts)

        def median(kind, col):
            return float(np.median([x[col] for x in self.lat[kind]]))
        return {"kind": "realtime", "runner": self, "trace": tr,
                "wbc_device_ms": median("wbc", 2),
                "wbc_enqueue_ms": median("wbc", 1),
                "replan_device_ms": median("plan", 2)}

    # -- the marked profile (portbench/marked.py) -------------------------
    marked_units = [("wbc.build", "wbc.end"), ("plan.pack", "plan.end")]

    def _trace_rounds(self, n):
        """n rounds of the traced window: a replan, then its WBC ticks,
        each fenced."""
        warm = self.cold()
        per = self.tr["wbc_per_plan"]
        for i in range(n):
            with trace_mod.span("planner.plan"):
                out = self.plan_call(i, warm)
            warm = self.next_warm(out)
            common.sync()
            for k in range(per):
                with trace_mod.span("wbc.solve"):
                    self.wbc_call(i * per + k)
                common.sync()

    def marked_work(self):
        """The traced window's rounds, after one round that captures the
        marked graphs."""
        self._trace_rounds(1)
        return lambda: self._trace_rounds(self.tr["trace_rounds"])

    @staticmethod
    def marked_numbers(seen) -> dict:
        """The QP's busy time a WBC call, the median over the calls."""
        calls = seen["units"][("wbc.build", "wbc.end")]
        if not calls:
            return {}
        return {"wbc_qp_ms": marked.busy_ms(calls, seen["others"],
                                            lambda s: s == "wbc.qp",
                                            np.median)}

    # -- the comparison ---------------------------------------------------
    def release(self):
        """The sampled calls' inputs and outputs on the host."""
        f32 = torch.float32
        self.judged = {
            "wbc": [(i, common.floats_to(out, f32))
                    for i, out in self.keep["wbc"].items],
            "plan": [(i, common.floats_to(w, f32), common.floats_to(out, f32))
                     for i, w, out in self.keep["plan"].items]}
        self.plans = self.ticks = self.keep = None

    def _reference(self, wbc_calls, plan_calls, wbc_stop, plan_stop, dtype,
                   device="cpu"):
        """The reference's WBC solves and plans of the given calls, batched
        over the calls, each lane stopped at its `*_stop` iterations (None:
        at the tolerances)."""
        from ..reference import planner as rplanner, wbc as rwbc
        from ..reference.ops.riccati import WarmStart as RWarm
        n = self.tr["pool"]
        wi = [i % n for i in wbc_calls]
        st, ref = self._wbc_inputs(self.wbc_host, wi, device, dtype, rwbc)
        w = rwbc._solve_eager(self.rcfg, st, ref,
                              None if wbc_stop is None
                              else wbc_stop.to(device))
        x0, refs = self._plan_inputs(self.plan_host,
                                     [i % n for i, _ in plan_calls], device,
                                     dtype, rplanner)
        warm = RWarm(*(torch.cat([getattr(wm, f) for _, wm in plan_calls])
                       .to(device=device, dtype=dtype if f != "valid"
                           else torch.bool)
                       for f in ("u", "z", "s", "valid")))
        p = rplanner.plan(self.rcfg, x0, refs, warm,
                          None if plan_stop is None else plan_stop.to(device))
        return w, p

    def judge(self, wbc_out, plan_out) -> dict:
        """The numbers compared, of the sampled calls' outputs: the WBC's
        torques, accelerations and forces and the plan's forces and
        states, each a gap ratio of the float64 reference stopped at the
        judged side's iteration counts; the WBC's counts against the
        float64 reference's own stops at its tolerances (a warm replan
        stops after 2-7 iterations, too few for its counts to tell a
        broken stop from a stop at the margin; the cold plans of the plan
        and sweep cells hold them)."""
        wbc_calls = [i for i, _ in self.judged["wbc"]]
        plan_calls = [(i, w) for i, w, _ in self.judged["plan"]]
        wstop = wbc_out.sol.iters.to(torch.int64)
        pstop = plan_out.sol.iters.to(torch.int64)
        w64, p64 = self._reference(wbc_calls, plan_calls, wstop, pstop,
                                   torch.float64)
        w32, p32 = self._reference(wbc_calls, plan_calls, wstop, pstop,
                                   torch.float32)
        w_own, _ = self._reference(wbc_calls, plan_calls, None, None,
                                   torch.float64)
        floor = self.run.cell.limits["floor"]
        f = ("tau", "udot", "forces")
        wbc = common.lane_gaps([getattr(wbc_out, k) for k in f],
                               [getattr(w64, k) for k in f],
                               [getattr(w32, k) for k in f])
        f = ("forces", "states")
        plan = common.lane_gaps([getattr(plan_out, k) for k in f],
                                [getattr(p64, k) for k in f],
                                [getattr(p32, k) for k in f])
        return {"wbc": wbc, "plan": plan,
                "wbc_ratio": float(common.gap_ratio(*wbc, floor).max()),
                "plan_ratio": float(common.gap_ratio(*plan, floor).max()),
                "wbc_iters_short": common.iters_short(w_own.sol.iters,
                                                      wstop),
                "wbc_iters_own_max": int(w_own.sol.iters.max())}

    def check(self) -> dict:
        return self.judge(
            common.concat([out for _, out in self.judged["wbc"]]),
            common.concat([out for _, _, out in self.judged["plan"]]))

    # -- the control --------------------------------------------------------
    def control(self):
        """The reference in the program's place, TF32 on, on the card, call
        by call at B=1, each stopping at its own tolerances."""
        from ..reference._precision import tf32_control
        dev = self.run.device
        wbc_outs, plan_outs = [], []
        with tf32_control():
            for i, _ in self.judged["wbc"]:
                wbc_outs.append(self._control_wbc(i, dev))
            for i, w, _ in self.judged["plan"]:
                plan_outs.append(self._control_plan(i, w, dev))
        return (common.floats_to(common.concat(wbc_outs), torch.float32),
                common.floats_to(common.concat(plan_outs), torch.float32))

    def _control_wbc(self, i, dev):
        from ..reference import wbc as rwbc
        st, ref = self._wbc_inputs(self.wbc_host, [i % self.tr["pool"]], dev,
                                   torch.float32, rwbc)
        return rwbc._solve_eager(self.rcfg, st, ref)

    def _control_plan(self, i, warm, dev):
        from ..reference import planner as rplanner
        from ..reference.ops.riccati import WarmStart as RWarm
        x0, refs = self._plan_inputs(self.plan_host, [i % self.tr["pool"]],
                                     dev, torch.float32, rplanner)
        return rplanner.plan(self.rcfg, x0, refs,
                             RWarm(*(v.to(dev) for v in warm)))
