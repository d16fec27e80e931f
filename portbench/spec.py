"""What a cell is made of, found by name.

`BENCHMARK.json` at the checkout's root names each cell's configuration
and traffic mix.  Every piece lives in a file of its own, found by that
name, so that a new cell, configuration, traffic mix or per-layer metric
is a new file and a new entry, never an edit:

    portbench/configs/<config>.json     the configuration as it is run
    portbench/traffic/<traffic>.json    the traffic mix: its "kind" names
                                        the runner in portbench/kinds/
    portbench/limits/<workload>.json    the limits of the numbers compared
    portbench/metrics/<metric>.py       a reader a per-layer metric

A configuration file holds the whole EngineConfig tree; the program's and
the reference's configuration objects are both built from it, so that a
change of the program's defaults does not change what a cell runs.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path
from typing import NamedTuple

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent


class Cell(NamedTuple):
    name: str
    workload: dict      # the BENCHMARK.json entry
    config: dict        # portbench/configs/<config>.json
    traffic: dict       # portbench/traffic/<traffic>.json
    limits: dict        # portbench/limits/<workload>.json
    end_to_end: list    # the end-to-end metrics this cell reports
    per_layer: list     # the per-layer metrics this cell reports


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark(root: Path = ROOT) -> dict:
    return _json(root / "BENCHMARK.json")


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def cell(name: str, root: Path = ROOT) -> Cell:
    """The cell `name` of BENCHMARK.json, its files read."""
    bench = benchmark(root)
    by_name = {w["name"]: w for w in bench["workloads"]}
    if name not in by_name:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; there are "
                       f"{sorted(by_name)}")
    w = by_name[name]
    e2e = [m for m in bench["end_to_end"] if _reports(m, name)]
    moved = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"]
             if m["moves"] in moved and _reports(m, name)]
    return Cell(name=name, workload=w,
                config=_json(BENCH_DIR / "configs" / f"{w['config']}.json"),
                traffic=_json(BENCH_DIR / "traffic" / f"{w['traffic']}.json"),
                limits=_json(BENCH_DIR / "limits" / f"{name}.json"),
                end_to_end=e2e, per_layer=layer)


def build(template, values: dict, where: str = "engine"):
    """A frozen dataclass tree like `template` with every field set from
    `values` (nested dicts for nested dataclasses, lists for tuples).  A
    key missing from `values`, or one the tree lacks, raises."""
    names = [f.name for f in dataclasses.fields(template)]
    extra = set(values) - set(names)
    missing = set(names) - set(values)
    if extra or missing:
        raise ValueError(f"{where}: keys the configuration lacks {sorted(extra)}"
                         f", keys the file lacks {sorted(missing)}")
    kw = {}
    for n in names:
        old, new = getattr(template, n), values[n]
        if dataclasses.is_dataclass(old):
            kw[n] = build(old, new, f"{where}.{n}")
        elif isinstance(old, tuple):
            kw[n] = _tuple(new)
        else:
            kw[n] = new
    return dataclasses.replace(template, **kw)


def _tuple(v):
    return tuple(_tuple(x) for x in v) if isinstance(v, list) else v


def program_config(conf: dict):
    """The program's EngineConfig of a configuration file."""
    from apf_quadruped_tpu_torch.config import EngineConfig
    return build(EngineConfig(), conf["engine"])


def reference_config(conf: dict):
    """The reference's EngineConfig of a configuration file."""
    from .reference.config import EngineConfig
    return build(EngineConfig(), conf["engine"])


def load_module(path: Path, name: str):
    """The Python file `path` as a module (a reader's file name may hold
    dots, which an import statement cannot name)."""
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reader(metric: str):
    """The `read(obs)` function of the per-layer metric `metric`."""
    path = BENCH_DIR / "metrics" / f"{metric}.py"
    return load_module(path, f"portbench_metric_{metric.replace('.', '_')}").read
