"""One run of one cell: set-up, the window, the traced window, the
comparison with the reference, the result line (portbench/run.py says
what a run does, in order)."""

from __future__ import annotations

import importlib
import sys
from typing import NamedTuple

import torch

from . import common, spec

# exit codes of a run that prints no result
NO_CARD, FORBIDDEN_MODULE = 3, 4


class Run(NamedTuple):
    cell: spec.Cell
    seed: int
    seconds: float
    trace: bool
    device: torch.device
    control: bool = False      # keep what the control needs (control.py)


def runner(run: Run):
    """The traffic kind's runner (portbench/kinds/<kind>.py) for `run`."""
    kind = run.cell.traffic["kind"]
    return importlib.import_module(f"portbench.kinds.{kind}").Runner(run)


def cards_or_exit(n: int):
    if not torch.cuda.is_available() or torch.cuda.device_count() < n:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"portbench: the cell needs {n} CUDA card(s), this machine "
              f"has {have}: no result", file=sys.stderr, flush=True)
        sys.exit(NO_CARD)


def judged_numbers(cell: spec.Cell, found: dict) -> dict:
    """{name: {"value", "limit"}} of the numbers the cell's limits name."""
    return {k: {"value": found[k], "limit": lim}
            for k, lim in cell.limits.items() if k != "floor"}


def execute(run: Run, rnr=None) -> tuple[dict, dict]:
    """A run after the look for cards: (the result's keys but the checks,
    the checks).  Raises SystemExit(FORBIDDEN_MODULE) where a module of
    JAX or of the JAX package is loaded once the window has closed."""
    rnr = runner(run) if rnr is None else rnr
    cell = run.cell
    begun = common.process_age()
    rnr.traffic()
    made = common.process_age()
    rnr.warm()
    setup_s = common.process_age()
    print(f"portbench: set-up {setup_s:.2f} s: imports and the card "
          f"{begun:.2f} s, traffic {made - begun:.2f} s, kernels, warm-up "
          f"and graphs {setup_s - made:.2f} s", file=sys.stderr, flush=True)
    e2e = rnr.window()
    e2e["setup_s"] = setup_s
    device = common.device_info(run.device, cell.workload["chips"])
    bad = common.forbidden_modules()
    if bad:
        print(f"portbench: modules of JAX or the JAX package are loaded: "
              f"{bad}: no result", file=sys.stderr, flush=True)
        raise SystemExit(FORBIDDEN_MODULE)
    if rnr.captured_in_window:
        print(f"portbench: {rnr.captured_in_window} graph(s) captured inside "
              f"the window", file=sys.stderr, flush=True)
    result = {}
    if run.trace:
        obs = rnr.traced()
        tr = obs["trace"]
        print(f"portbench: traced window {tr.window_s:.6f} s, "
              f"{len(tr.kernels)} device operations, {tr.share:.2%} of the "
              f"counted launches recorded in {tr.tries} profile(s)"
              + ("" if tr.lossless else "; under the guard's 95%, so the "
                 "metrics read from the device's operations are left out"),
              file=sys.stderr, flush=True)
        metrics = {}
        for m in cell.per_layer:
            v = spec.reader(m["name"])(obs)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        device.update(busy_s=tr.busy_s, window_s=tr.window_s)
        result["breakdown"] = tr.breakdown()
        for line in obs.get("notes", ()):
            print(line, file=sys.stderr, flush=True)
    else:
        metrics = {m["name"]: {"value": e2e[m["name"]], "unit": m["unit"]}
                   for m in cell.end_to_end}
    attempted, failed = rnr.counts()
    rnr.release()
    if run.device.type == "cuda":
        torch.cuda.empty_cache()
    found = rnr.check()
    checks = judged_numbers(cell, found)
    checks["failed"] = {"value": failed, "limit": 0}
    correct = all(c["value"] <= c["limit"] for c in checks.values())
    return ({"correct": correct, "attempted": attempted, "failed": failed,
             "metrics": metrics, "device": device, **result}, checks)


def run_cell(workload: str, seed: int, seconds: float, trace: bool) -> int:
    cell = spec.cell(workload)
    cards_or_exit(cell.workload["chips"])
    run = Run(cell=cell, seed=seed, seconds=seconds, trace=trace,
              device=torch.device("cuda", 0))
    torch.cuda.set_device(run.device)
    try:
        result, checks = execute(run)
    except SystemExit as e:
        return int(e.code)
    common.emit(result, checks)
    return 0
