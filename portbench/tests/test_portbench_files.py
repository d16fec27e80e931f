"""Every file a cell is made of is found by name and parses, and
BENCHMARK.json keeps to the contract's shape."""

from __future__ import annotations

import json
import re

import pytest

from portbench import spec
from portbench.kinds import plan, realtime, sweep  # noqa: F401

BENCH = spec.benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["portbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert (spec.ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024


@pytest.mark.parametrize("name", [w["name"] for w in BENCH["workloads"]])
def test_cell_files_found_and_parsed(name):
    cell = spec.cell(name)
    assert cell.traffic["kind"] in ("sweep", "realtime", "plan")
    assert "floor" in cell.limits and len(cell.limits) >= 2
    assert all(isinstance(v, (int, float)) for v in cell.limits.values())
    e2e = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert cell.per_layer, "every cell reports a per-layer metric"
    assert cell.workload["chips"] == 1
    assert len(cell.workload["why"]) <= 200


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
