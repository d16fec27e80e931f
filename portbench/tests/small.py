"""Cells cut to a size the CPU tests can run: the same files, the
configuration's replan cycles cut to 20 ticks and the traffic's batches to
a handful of lanes, run on the CPU through the harness's own path (the
look for a card skipped)."""

from __future__ import annotations

import copy

import torch

from portbench import harness, spec

SIZES = {
    "sweep": dict(batch=4, batches=2, sweep_sim_seconds=0.1),
    "plan": dict(batch=12, batches=2, check_lanes=12),
    "realtime": dict(pool=4, check_calls=6),
}


def cell(name: str) -> spec.Cell:
    c = spec.cell(name)
    conf = copy.deepcopy(c.config)
    traffic = dict(c.traffic)
    traffic.update(SIZES[traffic["kind"]])
    if traffic["kind"] == "sweep":
        g = conf["engine"]["gait"]
        g["trot_cycle"] = g["crawl_cycle"] = g["fixed_cycle"] = 0.05
    return c._replace(config=conf, traffic=traffic)


def run(name: str, seed: int = 12345, seconds: float = 0.3,
        control: bool = False) -> harness.Run:
    return harness.Run(cell=cell(name), seed=seed, seconds=seconds,
                       trace=False, device=torch.device("cpu"),
                       control=control)


WORKLOADS = [w["name"] for w in spec.benchmark()["workloads"]]
