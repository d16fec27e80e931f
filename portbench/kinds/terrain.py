"""Terrain sweep traffic: the sweep kind's batches with each lane on a
height map of its own (towr's example worlds) and spawned at a pose of its
own, short of the world's feature.

Traffic file keys: the sweep kind's (portbench/kinds/sweep.py), and
worlds (names of the reference's sim/terrain.HEIGHT_WORLDS, dealt evenly
over each batch's lanes in an order drawn from the seed), spawn_x,
spawn_y ((low, high) ranges of each lane's spawn, m), spawn_yaw (every
lane's spawn yaw, rad), check_cycle (the cycle of the window's first sweep
that the comparison reads).

The generator is the sweep kind's, with each lane's height map, built on
the host in float64 from the reference's worlds, and its spawn added; both
sides get them in float32.  The window is the sweep kind's, and does not
close before the checked cycle has run.  From these spawns the feet reach
the features only after the first cycle, so the comparison reads cycle
`check_cycle` of the window's first sweep, and its first cycle besides:

- the checked cycle's plan, every lane, against the reference's head of
  that cycle from the program's LoopState at the cycle's start, stopped
  at the program's iterations: the 99th percentile over the lanes of the
  gap ratio (`plan_ratio_p99`).  A warm plan stopped after a few
  iterations parts from float64 on a few lanes by up to ~250x the
  reference's own float32 distance in any float32 order of sums (the
  reference's own on the card alike), so the widest lane (`plan_ratio`)
  is reported, unjudged.  And the program's iterations against the
  reference's own stop (`plan_iters_short`);
- the first cycle's cold plan, every lane, against the reference's first
  head from its own spawn, alike, its widest lane as in the sweep kind
  (`cold_plan_ratio`, `cold_plan_iters_short`).  A warm plan stops after
  a few iterations at a point that float32 moves by ~1e-2 N, so the
  checked cycle's `plan_ratio` tells the ground from flat ground but not
  an answer off by 0.1 N, nor a stop after the first iteration; the cold
  plan does, as in the sweep kind;
- the checked cycle's end state, the sweep kind's `state_gap` from that
  cycle's start.

The observations keep the sweep kind's name, so that its readers apply,
and add the window's mean of CycleMetrics.ground_feet; the marked profile
adds the busy time of the `ground` stages a tick.
"""

from __future__ import annotations

import sys
import time

import numpy as np
import torch

from .. import common, gen, marked
from . import sweep

F32 = np.float32
# the exit code of a run on a program whose sweeps cannot carry a height
# map a lane (its sweep.Scenario has no h_map): no result
NO_HEIGHT_MAPS = 5


class Runner(sweep.Runner):
    def __init__(self, run):
        super().__init__(run)
        if "h_map" not in self.sweep.Scenario._fields:
            print("portbench: the program's sweep.Scenario has no h_map, so "
                  "its sweeps cannot put a lane on a height map: no result",
                  file=sys.stderr, flush=True)
            raise SystemExit(NO_HEIGHT_MAPS)
        self.check_cycle = int(self.tr["check_cycle"])
        if not 0 <= self.check_cycle < self.n_cycles:
            raise ValueError(f"check_cycle {self.check_cycle} is not a "
                             f"cycle of a {self.n_cycles}-cycle sweep")

    # -- set-up ----------------------------------------------------------
    def traffic(self):
        """The sweep kind's scenarios, each batch's lanes dealt over the
        worlds and given spawns from a stream of their own."""
        run, tr = self.run, self.tr
        from ..reference.sim import terrain as rterrain
        maps = np.stack([rterrain.HEIGHT_WORLDS[w](
            self.rcfg.sim, dtype=torch.float64, device="cpu").h_map.numpy()
            for w in tr["worlds"]])
        self.host, self.deals = [], []
        for j in range(tr["batches"]):
            h = gen.scenarios(self.rcfg, tr["batch"], gen.rng(run.seed, 1, j),
                              tr["n_patches"], tr["target_x"], tr["target_y"],
                              tr["pushes"], tr["push_f_max"],
                              tr["push_horizon_s"])
            h, deal = self._on_worlds(h, maps, gen.rng(run.seed, 15, j))
            self.host.append(h)
            self.deals.append(deal)
        self.batches = [self._scenario(h) for h in self.host]
        common.sync()

    def _on_worlds(self, h: dict, maps: np.ndarray, g) -> tuple[dict, list]:
        """The host scenario `h` with each lane's height map (`maps`, one
        a world, dealt evenly in an order drawn from `g`) and spawn (drawn
        from `g` after the deal); and the deal."""
        tr, B = self.tr, self.tr["batch"]
        deal = g.permutation(np.resize(np.arange(len(maps)), B))
        spawn = np.stack([g.uniform(*tr["spawn_x"], B),
                          g.uniform(*tr["spawn_y"], B)], axis=-1)
        return {**h, "h_map": maps[deal].astype(F32),
                "spawn_xy": spawn.astype(F32),
                "spawn_yaw": np.full(B, tr["spawn_yaw"], F32)}, deal.tolist()

    # -- the window -----------------------------------------------------
    def window(self):
        """The sweep kind's window, checked at `check_cycle`, with the
        share of loaded foot-ticks on the features summed by cycle."""
        run, sweep_mod, cfg = self.run, self.sweep, self.cfg
        B = self.tr["batch"]
        dev = run.device
        conv = torch.zeros((), dtype=torch.float64, device=dev)
        bad = torch.zeros((), dtype=torch.int64, device=dev)
        crawl = torch.zeros((), dtype=torch.int64, device=dev)
        ground = torch.zeros(self.n_cycles, dtype=torch.float64, device=dev)
        runs = np.zeros(self.n_cycles, dtype=np.int64)
        graphs = len(self.graph.entries())
        cycles = sweeps = 0
        self.checked = None
        rates = []
        t0 = time.perf_counter()
        done = False
        while not done:
            j = sweeps % len(self.batches)
            scn = self.batches[j]
            st = sweep_mod.init_batch(cfg, scn)
            t_sweep, c0 = time.perf_counter(), cycles
            for c in range(self.n_cycles):
                checking = sweeps == 0 and c == self.check_cycle
                if checking:
                    start = common.tmap(torch.clone, st)
                st, m = sweep_mod.step_batch(cfg, scn, st, 1)
                if sweeps == 0 and c == 0:
                    cold = (st.warm_u, m.mpc_iters)
                conv += m.qp_converged.sum(dtype=torch.float64)
                bad += (~torch.isfinite(st.sim.q).all(dim=-1)).sum()
                crawl += m.crawling.sum()
                if m.ground_feet is not None:     # None: flat ground
                    ground[c] += m.ground_feet.sum(dtype=torch.float64)
                runs[c] += 1
                common.sync(dev)
                cycles += 1
                if checking:
                    self.checked = (j, start, st, m)
                if (time.perf_counter() - t0 >= run.seconds
                        and self.checked is not None):
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
        self.cold = cold
        self.captured_in_window = len(self.graph.entries()) - graphs
        ground = ground.cpu().numpy()
        self.out = {"lane_cycles": cycles * B,
                    "bad_lane_cycles": int(bad.item()),
                    "qp_converged_share": float(conv.item()) / (cycles * B),
                    "crawl_lane_cycles": int(crawl.item()),
                    "ground_feet_share": float(ground.sum()) / (cycles * B),
                    "ground_feet_by_cycle": [
                        float(s) / (n * B) for s, n in zip(ground, runs)
                        if n]}
        return {"scenario_ticks_per_s": cycles * B * self.n_ticks / elapsed}

    # -- the traced window ------------------------------------------------
    def traced(self) -> dict:
        obs = super().traced()
        out = self.out
        obs["worlds"] = list(self.tr["worlds"])
        obs["ground_feet_share"] = out["ground_feet_share"]
        obs["notes"].append(
            "portbench: ground_feet (loaded foot-ticks on raised or tilted "
            "ground) by cycle of a sweep, the window's mean "
            + " ".join(f"{v:.4f}" for v in out["ground_feet_by_cycle"])
            + "; lanes a world in the checked batch "
            + ", ".join(f"{w} {self.deals[0].count(i)}"
                        for i, w in enumerate(self.tr["worlds"])))
        return obs

    @staticmethod
    def marked_numbers(seen) -> dict:
        """The sweep kind's numbers, and the `ground` stages' busy time a
        tick, the mean over the ticks, where the profile has such marks."""
        out = sweep.Runner.marked_numbers(seen)
        ticks = seen["units"][("tick.refs", "tick.end")]
        if ticks and any(s == "ground" for s, _, _ in seen["marks"]):
            out["tick_ground_ms"] = marked.busy_ms(
                ticks, seen["others"], lambda s: s == "ground")
        return out

    # -- the comparison ---------------------------------------------------
    def release(self):
        """The sweep kind's; every lane's LoopState at the checked cycle's
        start, for the reference's head; the first cycle's plan and its
        iterations; all on the host."""
        self.head_start = common.floats_to(self.checked[1], torch.float32)
        u, iters = self.cold
        self.cold_judged = (u.float().cpu(),
                            iters.reshape(self.tr["batch"], -1)[:, 0].cpu())
        self.cold = None
        super().release()

    def head_state(self, j, dtype, device="cpu", cold=False):
        """The reference's LoopState at the checked cycle's start, every
        lane: the program's state; with `cold`, at the first cycle's start,
        the reference's own spawn."""
        if cold:
            return self.reference_spawn(j, dtype, device)
        return common.recast(common.floats_to(self.head_start, dtype, device),
                             common.reference_types())

    def reference_head(self, j, stop, dtype, device="cpu", cold=False):
        """The warm start the reference's head of the checked cycle (with
        `cold`, of the first) on batch j stashes for the next, and its
        plan's iterations: from `head_state`, the plan stopped at `stop`
        (None: at its tolerances)."""
        from ..reference.runtime import loop as rloop

        def t(k):
            return self._host(j, k, dtype, device)
        head = rloop._cycle_head_eager(
            self.rcfg, self.head_state(j, dtype, device, cold),
            self.reference_terrain(j, dtype, device), t("target_xy"),
            t("dist_sched"),
            plan_stop_at=None if stop is None else stop.to(device))
        return head.tail.warm_next[0], head.tail.mpc_iters

    def judge(self, warm_u, iters, cold_u=None, cold_iters=None) -> dict:
        """The sweep kind's numbers of the checked cycle's plan, and with
        `cold_u`, the same of the first cycle's (`cold_`...)."""
        out = self._plan_numbers(warm_u, iters, cold=False)
        if cold_u is not None:
            out.update({f"cold_{k}": v for k, v in self._plan_numbers(
                cold_u, cold_iters, cold=True).items()})
        return out

    def _plan_numbers(self, warm_u, iters, cold) -> dict:
        """A plan's forces, every lane, as a gap ratio of the float64
        reference stopped at the judged iteration counts over the
        reference's own float32 distance from it (the widest lane, and the
        99th percentile over the lanes); its iterations against the
        float64 reference's own."""
        stop = iters.to(torch.int64)
        j = self.judged_batch
        r64, _ = self.reference_head(j, stop, torch.float64, cold=cold)
        r32, _ = self.reference_head(j, stop, torch.float32, cold=cold)
        _, own = self.reference_head(j, None, torch.float64, cold=cold)
        if not cold:
            self.warm_refs = (stop, r64, r32)
        plan = common.lane_gaps([warm_u], [r64], [r32])
        ratios = common.gap_ratio(*plan, self.run.cell.limits["floor"])
        return {"plan": plan, "plan_ratio": float(ratios.max()),
                "plan_ratio_p99": float(np.percentile(ratios, 99)),
                "plan_iters_short": common.iters_short(own, stop),
                "plan_iters_own_max": int(own.max())}

    def check(self) -> dict:
        out = {**self.judge(*self.judged, *self.cold_judged),
               **self.judge_state(self.end)}
        if self.run.control:
            out.update(self.witness())
        return out

    def witness(self) -> dict:
        """For the control's readings: a second float32 answer of the
        checked cycle's plan, the reference's on the run's device (TF32
        off, its own order of sums), stopped where the program stopped, as
        the same gap ratio, every lane (`witness`), its widest and 99th
        percentile; and each lane's R[2,2] at the cycle's start (under
        0.7 the program's sweep counts the robot as fallen)."""
        stop, r64, r32 = self.warm_refs
        w32, _ = self.reference_head(self.judged_batch, stop, torch.float32,
                                     self.run.device)
        ratios = common.gap_ratio(*common.lane_gaps([w32], [r64], [r32]),
                                  self.run.cell.limits["floor"])
        return {"witness": ratios,
                "witness_plan_ratio": float(ratios.max()),
                "witness_plan_ratio_p99": float(np.percentile(ratios, 99)),
                "upright": self.head_start.sim.R_wb[:, 2, 2].cpu().numpy()}

    def control(self):
        """The reference in the program's place, TF32 on, on the card: the
        checked cycle's head and the first cycle's on the checked batch,
        every lane, each plan stopping at its own tolerances."""
        from ..reference._precision import tf32_control
        with tf32_control():
            out = [self.reference_head(self.judged_batch, None,
                                       torch.float32, self.run.device, cold)
                   for cold in (False, True)]
        return tuple(v.float().cpu() if v.is_floating_point() else v.cpu()
                     for u, iters in out for v in (u, iters))

    def reference_spawn(self, j, dtype, device="cpu"):
        """The reference's LoopState of every lane of batch j at its spawn,
        as the program's `sweep.init_batch` makes it: each lane at rest with
        its base at the spawn's xy and yaw and its friction anchors under
        its feet there, as loop.init(xy, yaw) puts one robot."""
        from ..reference.models import rbd
        from ..reference.ops.rotations import rot_z
        from ..reference.runtime import loop as rloop
        st = rloop.init(self.rcfg, self.tr["batch"], dtype=dtype,
                        device=device)
        p = torch.cat([self._host(j, "spawn_xy", dtype, device),
                       st.sim.p_base[:, 2:3]], dim=-1)
        R = rot_z(self._host(j, "spawn_yaw", dtype, device))
        feet = rbd.foot_positions_world(self.rcfg.robot, p, R, st.sim.q)
        return st._replace(sim=st.sim._replace(
            p_base=p, R_wb=R, anchor=feet[..., 0:2].clone()))
