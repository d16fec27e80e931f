"""What a run loads: the harness, every traffic runner in portbench/kinds/
(found by file, so that a new kind is held to this without an edit), its
metric readers, its reference and the program's modules it drives pull in
no module whose top-level name is jax, jaxlib or apf_quadruped_tpu (names
compared whole: the port's own name begins with the JAX package's), and
the reference pulls in nothing of the program."""

from __future__ import annotations

import json
import subprocess
import sys

from portbench import spec

LOAD_ALL = """
import importlib, json, pkgutil, sys
sys.path.insert(0, {root!r})
import portbench.kinds, portbench.run, portbench.harness, portbench.control
from portbench import spec
kinds = [m.name for m in pkgutil.iter_modules(portbench.kinds.__path__)]
for kind in kinds:
    importlib.import_module("portbench.kinds." + kind)
print(json.dumps(kinds))
import apf_quadruped_tpu_torch.runtime.sweep, apf_quadruped_tpu_torch.planner
import apf_quadruped_tpu_torch.wbc, apf_quadruped_tpu_torch.runtime.graph
for m in spec.benchmark()["per_layer"]:
    spec.reader(m["name"])
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""

LOAD_REFERENCE = """
import json, sys
sys.path.insert(0, {root!r})
import portbench.reference.runtime.loop, portbench.reference.planner
import portbench.reference.wbc, portbench.gen, portbench.counts.spd_chol
import portbench.counts.resident_ipm, portbench.counts.resident_qp
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def _printed(code: str) -> list:
    out = subprocess.run([sys.executable, "-c", code.format(root=str(
        spec.ROOT))], capture_output=True, text=True, check=True,
        cwd=spec.ROOT)
    return [json.loads(line) for line in out.stdout.strip().splitlines()]


def _top_level(code: str) -> set:
    return set(_printed(code)[-1])


def test_a_run_loads_no_jax():
    kinds, names = _printed(LOAD_ALL)
    used = {spec.cell(w["name"]).traffic["kind"]
            for w in spec.benchmark()["workloads"]}
    assert used <= set(kinds)
    names = set(names)
    assert "apf_quadruped_tpu_torch" in names and "portbench" in names
    assert not names & {"jax", "jaxlib", "flax", "apf_quadruped_tpu"}


def test_the_reference_loads_nothing_of_the_program():
    names = _top_level(LOAD_REFERENCE)
    assert not names & {"jax", "jaxlib", "flax", "apf_quadruped_tpu",
                        "apf_quadruped_tpu_torch"}


def test_forbidden_names_compared_whole(monkeypatch):
    from portbench import common
    monkeypatch.setitem(sys.modules, "apf_quadruped_tpu_torchx", sys)
    monkeypatch.setitem(sys.modules, "jaxlike.sub", sys)
    assert common.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "jax.numpy", sys)
    assert common.forbidden_modules() == ["jax"]
