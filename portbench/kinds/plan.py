"""Plan traffic: cold `planner.plan` at a large batch, enqueued back to back
on a few batches of problems replayed round-robin, fenced at the window's
end.

Traffic file keys: batch (B), batches (problem batches made in set-up),
in_flight (plans enqueued ahead of the device: enough to keep it busy,
few enough that the window ends near `seconds`), check_lanes (lanes of
each batch the reference checks, a seeded sample), trace_plans (plans of
the traced window), gait_flags (optional: the contact schedules dealt
evenly over each batch's lanes, `gen.plan_problems`; default [1]).

The problems are bench.py's (DogBot standing in a trot schedule, a 6 cm
CoM step, seeded noise), each lane's schedule one of `gait_flags`.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from .. import common, gen, marked, spec
from .. import trace as trace_mod
from ..counts import resident_ipm
from ..counts.peaks import least_seconds


class Runner:
    def __init__(self, run):
        from apf_quadruped_tpu_torch import planner
        from apf_quadruped_tpu_torch.runtime import graph
        self.run, self.planner, self.graph = run, planner, graph
        self.tr = run.cell.traffic
        self.cfg = spec.program_config(run.cell.config)
        self.rcfg = spec.reference_config(run.cell.config)

    def _inputs(self, h, dev, dtype=None, mod=None, lanes=None):
        planner = self.planner if mod is None else mod
        idx = slice(None) if lanes is None else np.asarray(lanes)

        def t(k):
            return torch.as_tensor(np.ascontiguousarray(h[k][idx]),
                                   device=dev, dtype=dtype)
        return t("x0"), planner.MpcRefs(**{k: t(k) for k in (
            "contacts", "feet_w", "x_ref", "yaw_ref")})

    # -- set-up ----------------------------------------------------------
    def traffic(self):
        run, tr = self.run, self.tr
        self.host = [gen.plan_problems(self.rcfg, tr["batch"],
                                       gen.rng(run.seed, 4, j),
                                       tr.get("gait_flags", (1,)))
                     for j in range(tr["batches"])]
        self.batches = [self._inputs(h, run.device) for h in self.host]
        common.sync()

    def warm(self):
        """A plan of each batch, the first of which captures the graph."""
        for x0, refs in self.batches:
            self.planner.plan(self.cfg, x0, refs)
        common.sync()

    # -- the window -----------------------------------------------------
    def window(self):
        run, tr = self.run, self.tr
        nb = len(self.batches)
        on_card = run.device.type == "cuda"
        ring = [torch.cuda.Event() if on_card else None
                for _ in range(tr["in_flight"])]
        graphs = len(self.graph.entries())
        bad = torch.zeros((), dtype=torch.int64, device=run.device)
        self.last = [None] * nb
        n = 0
        t0 = time.perf_counter()
        # every batch at least once, so that each has a plan to judge
        while n < nb or time.perf_counter() - t0 < run.seconds:
            if on_card:     # wait for the plan `in_flight` back
                ring[n % len(ring)].synchronize()
            j = n % nb
            out = self.planner.plan(self.cfg, *self.batches[j])
            bad += (~torch.isfinite(out.forces).flatten(1).all(dim=1)).sum()
            if on_card:
                ring[n % len(ring)].record()
            self.last[j] = out
            n += 1
        common.sync()
        elapsed = time.perf_counter() - t0
        self.captured_in_window = len(self.graph.entries()) - graphs
        self.out = {"plans": n, "elapsed_s": elapsed, "bad": int(bad.item())}
        return {"plan_solves_per_s": n * tr["batch"] / elapsed}

    def counts(self):
        return self.out["plans"] * self.tr["batch"], self.out["bad"]

    # -- the traced window ------------------------------------------------
    def traced(self) -> dict:
        nb = len(self.batches)
        trace = trace_mod.profile(self._trace_plans, self.graph._counts)
        sols = [out.sol for out in self.last if out is not None]
        iters = torch.cat([s.iters for s in sols]).double()
        roof = None
        count, secs = trace_mod.seconds_of(trace, resident_ipm.KERNEL)
        if count:
            need = 0.0
            for n in range(count):
                sol = self.last[n % nb].sol
                need += least_seconds(*resident_ipm.plan_work(
                    self.cfg.mpc.horizon, sol.iters.cpu().numpy(),
                    sol.converged.cpu().numpy()))[0]
            roof = 100.0 * need / secs
        return {"kind": "plan", "runner": self, "trace": trace,
                "ipm_iters_mean": float(iters.mean()),
                "resident_roofline_pct": roof}

    # -- the marked profile (portbench/marked.py) -------------------------
    marked_units = [("plan.pack", "plan.end")]

    def _trace_plans(self):
        """The traced window's plans, back to back."""
        nb = len(self.batches)
        for n in range(self.tr["trace_plans"]):
            with trace_mod.span("planner.plan"):
                self.planner.plan(self.cfg, *self.batches[n % nb])

    def marked_work(self):
        """The traced window's plans, after one that captures the marked
        graph."""
        self.planner.plan(self.cfg, *self.batches[0])
        common.sync()
        return self._trace_plans

    @staticmethod
    def marked_numbers(seen) -> dict:
        """The packing's and unpacking's busy time a plan (every stage but
        the solver call's), the mean over the plans."""
        plans = seen["units"][("plan.pack", "plan.end")]
        if not plans:
            return {}
        return {"plan_pack_ms": marked.busy_ms(plans, seen["others"],
                                               lambda s: s != "plan.ipm")}

    # -- the comparison ---------------------------------------------------
    def release(self):
        """A seeded sample of each batch's lanes, their last plan on the
        host."""
        tr = self.tr
        gen_l = gen.rng(self.run.seed, 13)
        self.lanes = [np.sort(gen_l.choice(tr["batch"], tr["check_lanes"],
                                           replace=False))
                      for _ in self.host]
        self.judged = common.concat([
            common.floats_to(common.take(out, lanes), torch.float32)
            for out, lanes in zip(self.last, self.lanes)])
        self.batches = None if not self.run.control else self.batches
        self.last = None

    def _reference(self, stop, dtype, device="cpu"):
        from ..reference import planner as rplanner
        x0, refs = zip(*(self._inputs(h, device, dtype, rplanner, lanes)
                         for h, lanes in zip(self.host, self.lanes)))
        return rplanner.plan(self.rcfg, torch.cat(x0), common.concat(refs),
                             stop_at=None if stop is None else stop.to(device))

    def judge(self, out) -> dict:
        """The numbers compared, of the sampled lanes' plans: the forces and
        states as a gap ratio of the float64 reference stopped at the judged
        side's iteration counts; those counts against the float64
        reference's own stop at its tolerances."""
        stop = out.sol.iters.to(torch.int64)
        p64 = self._reference(stop, torch.float64)
        p32 = self._reference(stop, torch.float32)
        own = self._reference(None, torch.float64).sol.iters
        f = ("forces", "states")
        plan = common.lane_gaps([getattr(out, k) for k in f],
                                [getattr(p64, k) for k in f],
                                [getattr(p32, k) for k in f])
        floor = self.run.cell.limits["floor"]
        return {"plan": plan,
                "plan_ratio": float(common.gap_ratio(*plan, floor).max()),
                "plan_iters_short": common.iters_short(own, stop),
                "plan_iters_own_max": int(own.max())}

    def check(self) -> dict:
        return self.judge(self.judged)

    # -- the control --------------------------------------------------------
    def control(self):
        """The reference in the program's place, TF32 on, on the card, at
        the cell's batch: each batch planned whole, its sampled lanes
        judged."""
        from ..reference import planner as rplanner
        from ..reference._precision import tf32_control
        outs = []
        with tf32_control():
            for h, lanes in zip(self.host, self.lanes):
                x0, refs = self._inputs(h, self.run.device, torch.float32,
                                        rplanner)
                out = rplanner.plan(self.rcfg, x0, refs)
                outs.append(common.floats_to(common.take(out, lanes),
                                             torch.float32))
        return (common.concat(outs),)
