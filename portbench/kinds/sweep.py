"""Sweep traffic: batches of slippery-patch scenarios walked through the
closed loop, a sweep at a time, each sweep cold from its spawn.

Traffic file keys: batch (B), batches (scenario batches made in set-up,
then reused round-robin), sweep_sim_seconds (simulated seconds a sweep:
its cycles are this over the configuration's replan cycle), n_patches,
target_x, target_y, pushes, push_f_max, push_horizon_s (the scenario
generator's parameters), trace_cycle_s (the replan cycle of the traced
window), state_lanes (the lanes whose cycle the reference runs again).

The window drives `sweep.init_batch` and `sweep.step_batch`, a cycle a
call, until `seconds` have passed, and finishes the cycle underway.  The
comparison reads the first cycle of the window's first sweep:

- its plan, every lane, against the reference's first cycle from its own
  spawn state, stopped at the program's iterations (`plan_ratio`), and
  the program's iterations against the reference's own stop at its
  tolerances (`plan_iters_short`);
- its end state, `state_lanes` lanes drawn from the seed one in each
  block of the batch, against the float64 reference's own cycle (head,
  every tick, tail) from the program's state at the cycle's start
  (`state_gap`): how far the program's end lies from the reference's, as
  a share of how far the reference moved.  It is no test of precision
  (over a cycle a TF32 tick is damped to the float32 twins' spread,
  PERF.md) but of the tick scan's work: a scan that leaves the state
  unchanged reads 1, and so does one that leaves the batch's second
  half (the lanes are drawn one a block, so half of them lie there).
"""

from __future__ import annotations

import dataclasses
import sys
import time

import numpy as np
import torch

from .. import common, gen, marked, spec
from .. import trace as trace_mod
from ..counts import resident_qp, spd_chol
from ..counts.peaks import least_seconds

# the benchmark's span around the program's tick scan in the traced cycle
SCAN = "loop._scan_ticks"
# what `state_gap` reads of the end state: the base position, which
# carries the cycle's progress (PERF.md: the other leaves barely move over
# a cycle, so their share is rounding's), and the percentile over the
# lanes, which a few chaotic lanes do not reach
STATE_LEAVES = ("p_base",)
STATE_QUANTILE = 75
# the leaves of a host scenario that make the reference's Terrain, each
# where the generator gave it (h_map None: flat ground)
TERRAIN_LEAVES = ("mu_map", "h_map")


def _cycle_seconds(g) -> float:
    return {"trot": g.trot_cycle, "adaptive": g.crawl_cycle,
            "crawl": g.crawl_cycle}.get(g.mode, g.fixed_cycle)


class Runner:
    def __init__(self, run):
        from apf_quadruped_tpu_torch.runtime import graph, sweep
        self.run, self.sweep, self.graph = run, sweep, graph
        self.tr = run.cell.traffic
        self.cfg = spec.program_config(run.cell.config)
        self.rcfg = spec.reference_config(run.cell.config)
        self.cycle_s = _cycle_seconds(self.cfg.gait)
        self.n_ticks = int(round(self.cycle_s / self.cfg.sim.dt))
        self.n_cycles = int(round(self.tr["sweep_sim_seconds"] / self.cycle_s))
        B, n = self.tr["batch"], self.tr["state_lanes"]
        g = gen.rng(run.seed, 14)
        self.lanes = (np.arange(B) if B <= n else np.array(
            [i * B // n + int(g.integers(0, B // n)) for i in range(n)]))

    # -- set-up ----------------------------------------------------------
    def traffic(self):
        run, tr = self.run, self.tr
        self.host = [gen.scenarios(self.rcfg, tr["batch"],
                                   gen.rng(run.seed, 1, j),
                                   tr["n_patches"], tr["target_x"],
                                   tr["target_y"], tr["pushes"],
                                   tr["push_f_max"], tr["push_horizon_s"])
                     for j in range(tr["batches"])]
        self.batches = [self._scenario(h) for h in self.host]
        common.sync()

    def warm(self):
        """One cycle, which captures the cycle's head, tick scan and tail."""
        st = self.sweep.init_batch(self.cfg, self.batches[0])
        self.sweep.step_batch(self.cfg, self.batches[0], st, 1)
        common.sync()

    def _scenario(self, h):
        return self.sweep.Scenario(**{k: torch.as_tensor(
            v, device=self.run.device) for k, v in h.items()})

    # -- the window -----------------------------------------------------
    def window(self):
        run, sweep, cfg = self.run, self.sweep, self.cfg
        B = self.tr["batch"]
        dev = run.device
        conv = torch.zeros((), dtype=torch.float64, device=dev)
        bad = torch.zeros((), dtype=torch.int64, device=dev)
        crawl = torch.zeros((), dtype=torch.int64, device=dev)
        graphs = len(self.graph.entries())
        cycles = sweeps = 0
        self.checked = None
        rates = []
        t0 = time.perf_counter()
        done = False
        while not done:
            j = sweeps % len(self.batches)
            scn = self.batches[j]
            st = sweep.init_batch(cfg, scn)
            t_sweep, c0 = time.perf_counter(), cycles
            for c in range(self.n_cycles):
                if sweeps == 0 and c == 0:
                    # the checked cycle's start, kept apart from what
                    # the program may reuse
                    start = common.tmap(torch.clone, st)
                st, m = sweep.step_batch(cfg, scn, st, 1)
                conv += m.qp_converged.sum(dtype=torch.float64)
                bad += (~torch.isfinite(st.sim.q).all(dim=-1)).sum()
                crawl += m.crawling.sum()
                # the host waits for each cycle, so that the window ends
                # with the cycle underway at `seconds` and not queued ones
                common.sync(dev)
                cycles += 1
                if sweeps == 0 and c == 0:
                    self.checked = (j, start, st, m)
                if time.perf_counter() - t0 >= run.seconds:
                    done = True
                    break
            rates.append((cycles - c0) * B * self.n_ticks
                         / (time.perf_counter() - t_sweep))
            sweeps += 1
        common.sync()
        elapsed = time.perf_counter() - t0
        print("portbench: scenario-ticks/s of each sweep in the window "
              + " ".join(f"{r:.1f}" for r in rates), file=sys.stderr,
              flush=True)
        self.last = (j, st)
        self.captured_in_window = len(self.graph.entries()) - graphs
        self.out = {"lane_cycles": cycles * B,
                    "bad_lane_cycles": int(bad.item()),
                    "qp_converged_share": float(conv.item()) / (cycles * B),
                    "crawl_lane_cycles": int(crawl.item())}
        return {"scenario_ticks_per_s": cycles * B * self.n_ticks / elapsed}

    def counts(self):
        return self.out["lane_cycles"], self.out["bad_lane_cycles"]

    # -- the traced window ------------------------------------------------
    def traced(self) -> dict:
        """A cycle of the configuration cut to `trace_cycle_s` (the same
        tick, captured again for its shorter scan) from the window's last
        state, profiled after one untraced such cycle: once as the window
        runs it, for the device's idle share, the breakdown and the
        kernels' roofline, and once with the program's tick scan
        (`loop._scan_ticks`) between two synchronizations inside a span of
        the benchmark's own, for the device time of its ticks apart from
        the head's and the tail's (the fences leave the device idle while
        the host launches the scan's first graphs, so that profile gives
        nothing else)."""
        from apf_quadruped_tpu_torch.runtime import loop as ploop
        one = self._trace_cycle()
        n_ticks = int(round(self.tr["trace_cycle_s"] / self.cfg.sim.dt))

        real = ploop._scan_ticks

        def fenced(*args):
            common.sync()
            with trace_mod.span(SCAN):
                out = real(*args)
                common.sync()
            return out
        tr = trace_mod.profile(one, self.graph._counts)
        ploop._scan_ticks = fenced
        try:
            tr_scan = trace_mod.profile(one, self.graph._counts)
        finally:
            ploop._scan_ticks = real
        roof = tick_ms = None
        scan_busy = trace_mod.busy_within(tr_scan, trace_mod.SPAN + SCAN)
        if scan_busy is not None and tr_scan.lossless:
            tick_ms = scan_busy * 1e3 / n_ticks
        kernels = trace_mod.spd_kernels(tr)
        if kernels:
            need = busy = 0.0
            for (name, N), (count, secs) in kernels.items():
                nbytes, flops = spd_chol.kernel_work(name, N,
                                                     self.tr["batch"])
                need += count * least_seconds(nbytes, flops)[0]
                busy += secs
            roof = 100.0 * need / busy
        out = self.out
        return {"kind": "sweep", "runner": self, "trace": tr,
                "ticks": n_ticks, "tick_device_ms": tick_ms,
                "spd_roofline_pct": roof,
                "qp_roofline_pct": resident_qp.roofline_pct(
                    *trace_mod.seconds_of(tr, resident_qp.KERNEL),
                    self.tr["batch"], self.cfg.solver),
                "qp_converged_share": out["qp_converged_share"],
                "notes": [f"portbench: lane-cycles in crawl "
                          f"{out['crawl_lane_cycles']} of "
                          f"{out['lane_cycles']} in the window"]}

    def _trace_cycle(self):
        """The traced window's work: a function that runs one cycle of the
        configuration cut to `trace_cycle_s` from the window's last state,
        after one such cycle, run here, which captures the cut cycle's
        graphs."""
        cfg_t = self.cfg.replace(gait=dataclasses.replace(
            self.cfg.gait, trot_cycle=self.tr["trace_cycle_s"],
            crawl_cycle=self.tr["trace_cycle_s"],
            fixed_cycle=self.tr["trace_cycle_s"]))
        j, st = self.last
        scn = self.batches[j]
        st, _ = self.sweep.step_batch(cfg_t, scn, st, 1)
        common.sync()

        def one():
            with trace_mod.span("sweep.step_batch"):
                self.sweep.step_batch(cfg_t, scn, st, 1)
        return one

    # -- the marked profile (portbench/marked.py) -------------------------
    marked_units = [("tick.refs", "tick.end")]
    # one marked cycle cut as the traced window's, after one that captures
    # its marked graphs
    marked_work = _trace_cycle

    @staticmethod
    def marked_numbers(seen) -> dict:
        """The QP's and physics' busy time a tick, the mean over the
        ticks."""
        ticks, others = seen["units"][("tick.refs", "tick.end")], \
            seen["others"]
        if not ticks:
            return {}
        return {"tick_qp_ms": marked.busy_ms(ticks, others,
                                             lambda s: s == "wbc.qp"),
                "tick_physics_ms": marked.busy_ms(ticks, others,
                                                  lambda s: s == "physics")}

    # -- the comparison ---------------------------------------------------
    def release(self):
        """Keep on the host what the comparison reads of the checked cycle,
        the first of the window's first sweep: the plan its head made, as
        the next LoopState's warm start holds it, the iterations the plan
        ran, and the sampled lanes' state at its start and end; drop the
        program's state."""
        j, start, after, m = self.checked
        lanes = self.lanes
        self.judged_batch = j
        self.judged = (after.warm_u.float().cpu(),
                       m.mpc_iters.reshape(self.tr["batch"], -1)[:, 0].cpu())
        self.start = common.floats_to(common.take(start, lanes),
                                      torch.float32)
        self.end = [getattr(after.sim, k)[torch.as_tensor(lanes).to(
            after.sim.q.device)].float().cpu()
            for k in STATE_LEAVES]
        self.batches = self.checked = self.last = None

    def _host(self, j, key, dtype, device, lanes=None):
        v = self.host[j][key]
        return torch.as_tensor(v if lanes is None else v[lanes],
                               dtype=dtype, device=device)

    def reference_head(self, j, stop, dtype, device="cpu"):
        """The warm start the reference's first cycle on batch j stashes
        for the next (its plan's forces, leg-permuted for the mirrored trot
        pair), and its plan's iterations: the reference's own spawn state,
        navigation, footholds, references and plan, the plan stopped at
        `stop` (None: at its tolerances)."""
        from ..reference.runtime import loop as rloop

        def t(k):
            return self._host(j, k, dtype, device)
        head = rloop._cycle_head_eager(
            self.rcfg, self.reference_spawn(j, dtype, device),
            self.reference_terrain(j, dtype, device), t("target_xy"),
            t("dist_sched"),
            plan_stop_at=None if stop is None else stop.to(device))
        return head.tail.warm_next[0], head.tail.mpc_iters

    def reference_spawn(self, j, dtype, device="cpu"):
        """The reference's LoopState of every lane of batch j at its spawn,
        as the program's `sweep.init_batch` makes it: the spawn's xy on
        the base, the rest (yaw, the friction anchors) at the origin's
        spawn."""
        from ..reference.runtime import loop as rloop
        st = rloop.init(self.rcfg, self.tr["batch"], dtype=dtype,
                        device=device)
        return st._replace(sim=st.sim._replace(p_base=torch.cat(
            [self._host(j, "spawn_xy", dtype, device),
             st.sim.p_base[:, 2:3]], dim=-1)))

    def reference_terrain(self, j, dtype, device="cpu", lanes=None):
        """The reference's Terrain of batch j (its `lanes`; None: every
        lane) from every terrain leaf the host scenario holds
        (TERRAIN_LEAVES), so that the reference walks the ground the
        program walks."""
        from ..reference.sim import terrain as rterrain
        return rterrain.Terrain(
            extent=self.rcfg.sim.terrain_extent,
            res=self.rcfg.sim.terrain_res,
            **{k: self._host(j, k, dtype, device, lanes)
               for k in TERRAIN_LEAVES if k in self.host[j]})

    def reference_cycle(self, j, dtype, device="cpu") -> list:
        """The reference's own cycle of the sampled lanes of batch j, from
        the program's state at the checked cycle's start: the end state's
        compared leaves."""
        from ..reference.runtime import loop as rloop

        def t(k):
            return self._host(j, k, dtype, device, self.lanes)
        st = common.recast(common.floats_to(self.start, dtype, device),
                           common.reference_types())
        end, _ = rloop.run_cycle(
            self.rcfg, st, self.reference_terrain(j, dtype, device,
                                                  self.lanes),
            t("target_xy"), t("dist_sched"))
        return [getattr(end.sim, k) for k in STATE_LEAVES]

    def judge(self, warm_u, iters) -> dict:
        """The numbers compared of the checked cycle's plan, every lane:
        its forces as a gap ratio of the float64 reference, stopped at
        the judged side's iteration counts, over the reference's own
        float32 distance from it; its iterations against the float64
        reference's own."""
        stop = iters.to(torch.int64)
        j = self.judged_batch
        r64, _ = self.reference_head(j, stop, torch.float64)
        r32, _ = self.reference_head(j, stop, torch.float32)
        _, own = self.reference_head(j, None, torch.float64)
        plan = common.lane_gaps([warm_u], [r64], [r32])
        floor = self.run.cell.limits["floor"]
        return {"plan": plan,
                "plan_ratio": float(common.gap_ratio(*plan, floor).max()),
                "plan_iters_short": common.iters_short(own, stop),
                "plan_iters_own_max": int(own.max())}

    def judge_state(self, end) -> dict:
        """The number compared of the sampled lanes' end state: for each
        leaf, how far it lies from the float64 reference's cycle as a
        share of how far the reference moved it over the cycle, each
        leaf's STATE_QUANTILE percentile over the lanes, the widest over
        leaves.  A tick scan that leaves the state unchanged reads 1.  For
        the control's readings also what the same fault reads where it
        leaves the lanes of the batch's second half only."""
        j = self.judged_batch
        r64 = self.reference_cycle(j, torch.float64)
        start = [getattr(self.start.sim, k).float()
                 for k in STATE_LEAVES]
        floor = self.run.cell.limits["floor"]
        ratios = common.change_ratios(end, r64, start, floor)
        out = {"state": ratios, "state_gap": self._over_lanes(ratios),
               "state_gap_max": float(ratios.max())}
        if self.run.control:
            back = torch.as_tensor(self.lanes >= self.tr["batch"] // 2)
            half = [torch.where(back.reshape((-1,) + (1,) * (e.dim() - 1)),
                                s, e) for s, e in zip(start, end)]
            r = common.change_ratios(half, r64, start, floor)
            out["fault_half.state"] = r
            out["fault_half.state_gap"] = self._over_lanes(r)
        return out

    def _over_lanes(self, ratios) -> float:
        """The widest over leaves of each leaf's STATE_QUANTILE percentile
        over the sampled lanes."""
        q = np.percentile(ratios, STATE_QUANTILE, axis=1)
        return float(q.max())

    def check(self) -> dict:
        return {**self.judge(*self.judged), **self.judge_state(self.end)}

    # -- the control --------------------------------------------------------
    def control(self):
        """The reference in the program's place, TF32 on, on the card: the
        first cycle's head on the checked batch, every lane, its plan
        stopping at its own tolerances."""
        from ..reference._precision import tf32_control
        with tf32_control():
            warm_u, iters = self.reference_head(
                self.judged_batch, None, torch.float32,
                device=self.run.device)
        return warm_u.float().cpu(), iters.cpu()
