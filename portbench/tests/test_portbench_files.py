"""Every file a cell is made of is found by name and parses, and
BENCHMARK.json keeps to the contract's shape; a cell of a traffic kind
that no file of the harness names runs through the harness, its checks
and the marked profile as files of its own."""

from __future__ import annotations

import importlib
import json
import re
import sys
import textwrap
import types

import pytest
import torch

from portbench import harness, marked, spec, trace

BENCH = spec.benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["portbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert (spec.ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024


def _keeps_the_contract(cell: spec.Cell):
    """The checks every cell's files pass: its traffic kind names a module
    of portbench/kinds/ that defines a Runner, its limits, its metrics."""
    kind = importlib.import_module(f"portbench.kinds.{cell.traffic['kind']}")
    assert isinstance(kind.Runner, type)
    assert "floor" in cell.limits and len(cell.limits) >= 2
    assert all(isinstance(v, (int, float)) for v in cell.limits.values())
    e2e = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert cell.per_layer, "every cell reports a per-layer metric"
    assert cell.workload["chips"] == 1
    assert len(cell.workload["why"]) <= 200


@pytest.mark.parametrize("name", [w["name"] for w in BENCH["workloads"]])
def test_cell_files_found_and_parsed(name):
    _keeps_the_contract(spec.cell(name))


@pytest.mark.parametrize("conf", BENCH["configs"], ids=lambda c: c["name"])
def test_config_files_build_both_sides(conf):
    data = json.loads((spec.ROOT / conf["file"]).read_text())
    assert data["name"] == conf["name"]
    assert data["reduced"] == conf["reduced"] == []
    prog, ref = spec.program_config(data), spec.reference_config(data)
    assert prog.mpc.horizon == ref.mpc.horizon == data["engine"]["mpc"][
        "horizon"]
    assert prog.gait.mode == data["engine"]["gait"]["mode"]


def test_config_file_is_the_command_lines():
    """The files hold `sweep.cli_config(gait=...)` as the program has it."""
    import dataclasses

    from apf_quadruped_tpu_torch.runtime import sweep as psweep
    for name, gait in (("dogbot_trot", "trot"),
                       ("dogbot_adaptive", "adaptive")):
        data = json.loads((spec.BENCH_DIR / "configs" / f"{name}.json")
                          .read_text())
        assert json.loads(json.dumps(dataclasses.asdict(
            psweep.cli_config(gait=gait)))) == data["engine"]


def test_a_key_missing_or_extra_raises():
    conf = json.loads((spec.BENCH_DIR / "configs" / "dogbot_trot.json")
                      .read_text())
    conf["engine"]["mpc"]["nonsense"] = 1
    with pytest.raises(ValueError):
        spec.program_config(conf)
    del conf["engine"]["mpc"]["nonsense"]
    del conf["engine"]["mpc"]["horizon"]
    with pytest.raises(ValueError):
        spec.reference_config(conf)


@pytest.mark.parametrize("metric", BENCH["per_layer"],
                         ids=lambda m: m["name"])
def test_per_layer_reader_found(metric):
    read = spec.reader(metric["name"])
    assert read({}) is None, "a reader with nothing to read returns None"
    assert metric["moves"] in {m["name"] for m in BENCH["end_to_end"]}
    assert set(metric["workloads"]) <= {w["name"] for w in BENCH["workloads"]}


def test_names_units_and_bounds():
    names = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    names += [w["name"] for w in BENCH["workloads"]]
    names += [c["name"] for c in BENCH["configs"]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert "\n" not in m["layer"] and len(m["layer"]) <= 200
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))


# -- a traffic kind as files of its own ---------------------------------------

def _mark(stage, a):
    from apf_quadruped_tpu_torch.runtime import profiling
    return (f"void apf_mark_kernel<{profiling.STAGES.index(stage)}>()", a,
            a + 1.0)


# one marked WBC call: the QP stage's kernel busy 7 us
WBC_CALL = [_mark("wbc.build", 0.0), ("build", 1.0, 3.0),
            _mark("wbc.qp", 4.0), ("qp", 5.0, 12.0),
            _mark("wbc.torque", 13.0), _mark("wbc.end", 15.0)]


def _trace(kernels):
    return trace.Trace(kernels=list(kernels),
                       host=[("portbench: toy", 0.0, 20.0)], window_s=2e-5,
                       busy_s=1e-5, share=1.0, tries=1, lossless=True)


class ToyRunner:
    """A kind of traffic no file of the harness names: a window that
    counts, a traced window and a marked profile of its own (one WBC
    call's QP stage), and one number compared."""

    graph = types.SimpleNamespace(_counts=lambda: (0,))
    captured_in_window = 0
    marked_units = [("wbc.build", "wbc.end")]

    def __init__(self, run):
        self.run = run

    def traffic(self):
        self.calls = self.run.cell.traffic["calls"]

    def warm(self):
        pass

    def window(self):
        return {"toy_calls_per_s": float(self.calls)}

    def counts(self):
        return self.calls, 0

    def traced(self):
        return {"kind": "toy_kind", "runner": self, "trace": _trace(WBC_CALL)}

    def marked_work(self):
        return lambda: None

    @staticmethod
    def marked_numbers(seen):
        calls = seen["units"][("wbc.build", "wbc.end")]
        return {"qp_ms": marked.busy_ms(calls, seen["others"],
                                        lambda s: s == "wbc.qp")}

    def release(self):
        pass

    def check(self):
        return {"toy_gap": 0.5}


READER = """
from portbench import marked


def read(obs):
    if obs.get("kind") != "toy_kind":
        return None
    return (marked.observe(obs) or {}).get("qp_ms")
"""


@pytest.fixture
def toy_kind(tmp_path, monkeypatch):
    """A checkout whose BENCHMARK.json holds one cell of the kind
    `toy_kind`, made of new files alone (configuration, traffic, limits,
    reader), the kind's module put where the harness imports it from; the
    marked profile's trace made by hand."""
    bench = {"workloads": [{"name": "toy.calls", "config": "toy",
                            "traffic": "calls", "chips": 1,
                            "why": "a kind made of new files"}],
             "end_to_end": [
                 {"name": "toy_calls_per_s", "unit": "calls/s",
                  "better": "higher", "bound": 0.05, "source": "host_clock",
                  "workloads": ["toy.calls"]},
                 {"name": "setup_s", "unit": "s", "better": "lower",
                  "bound": 0.25, "source": "host_clock"}],
             "per_layer": [
                 {"name": "toy_qp_device_ms.toy", "unit": "ms",
                  "better": "lower", "source": "program_span",
                  "layer": "toy", "moves": "toy_calls_per_s",
                  "workloads": ["toy.calls"]}]}
    files = {"BENCHMARK.json": json.dumps(bench),
             "portbench/configs/toy.json": json.dumps({"name": "toy"}),
             "portbench/traffic/calls.json": json.dumps(
                 {"kind": "toy_kind", "calls": 3}),
             "portbench/limits/toy.calls.json": json.dumps(
                 {"floor": 1e-6, "toy_gap": 1.0}),
             "portbench/metrics/toy_qp_device_ms.toy.py": textwrap.dedent(
                 READER)}
    for rel, text in files.items():
        (tmp_path / rel).parent.mkdir(parents=True, exist_ok=True)
        (tmp_path / rel).write_text(text)
    monkeypatch.setattr(spec, "BENCH_DIR", tmp_path / "portbench")
    monkeypatch.setitem(sys.modules, "portbench.kinds.toy_kind",
                        types.SimpleNamespace(Runner=ToyRunner))
    monkeypatch.setattr(harness.common, "forbidden_modules", lambda: [])

    def profile(fn, launches):
        fn()
        return _trace(WBC_CALL)
    monkeypatch.setattr(marked.trace_mod, "profile", profile)
    return spec.cell("toy.calls", root=tmp_path)


def test_a_new_kind_is_new_files_only(toy_kind):
    """A cell of a kind that no file of the harness names goes through
    the contract's checks and the whole run, the marked profile's reader
    included, with no file of the harness edited."""
    _keeps_the_contract(toy_kind)
    assert spec.reader("toy_qp_device_ms.toy")({}) is None
    run = harness.Run(cell=toy_kind, seed=1, seconds=0.0, trace=True,
                      device=torch.device("cpu"))
    result, checks = harness.execute(run)
    assert result["correct"] and result["attempted"] == 3
    assert result["metrics"] == {"toy_qp_device_ms.toy": {
        "value": pytest.approx(7e-3), "unit": "ms"}}
    assert checks["toy_gap"] == {"value": 0.5, "limit": 1.0}
    run = run._replace(trace=False)
    result, _ = harness.execute(run)
    assert set(result["metrics"]) == {"toy_calls_per_s", "setup_s"}


def test_a_kind_without_a_marked_profile_reads_none(toy_kind, monkeypatch):
    """A runner that defines no marked profile gets no marked numbers and
    no error."""
    plain = type("PlainRunner", (), {
        k: v for k, v in vars(ToyRunner).items()
        if k == "__init__" or not k.startswith(("marked_", "__"))})
    monkeypatch.setitem(sys.modules, "portbench.kinds.toy_kind",
                        types.SimpleNamespace(Runner=plain))
    run = harness.Run(cell=toy_kind, seed=1, seconds=0.0, trace=True,
                      device=torch.device("cpu"))
    result, _ = harness.execute(run)
    assert result["correct"] and result["metrics"] == {}
