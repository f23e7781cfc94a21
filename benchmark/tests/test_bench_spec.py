"""BENCHMARK.json and the files it names: every cell, configuration, traffic
mix and metric parses and resolves by name, within the benchmark's
format."""

import json
import re

import pytest

from benchmark.harness import cell as C

SPEC = json.loads((C.ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def test_top_level_keys_and_limits():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert SPEC["paths"] == ["benchmark"]
    assert 1 <= SPEC["run_seconds"] <= 51
    assert len(json.dumps(SPEC)) < 64 * 1024
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in SPEC[k]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)


@pytest.mark.parametrize("conf", SPEC["configs"], ids=lambda c: c["name"])
def test_configuration_file(conf):
    assert set(conf) == {"name", "source", "file", "reduced", "why"}
    data = json.loads((C.ROOT / conf["file"]).read_text())
    assert data["name"] == conf["name"]
    assert data["reduced"] == conf["reduced"]
    assert data["macs_per_image"] > 0
    assert any(w["config"] == conf["name"] for w in SPEC["workloads"])


@pytest.mark.parametrize("entry", SPEC["workloads"], ids=lambda w: w["name"])
def test_cell_resolves(entry):
    assert set(entry) == {"name", "config", "traffic", "chips", "why"}
    assert entry["chips"] in (1, 4) and len(entry["why"]) <= 200
    cell = C.Cell(entry["name"])
    reported = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in reported and len(reported) >= 2
    assert cell.per_layer
    assert set(cell.workload["limits"])
    for m in cell.per_layer:
        assert callable(cell.reader(m["name"]))
        assert m["moves"] in reported


@pytest.mark.parametrize("metric", SPEC["end_to_end"] + SPEC["per_layer"],
                         ids=lambda m: m["name"])
def test_metric_entry(metric):
    assert UNIT.match(metric["unit"]) and metric["better"] in ("lower",
                                                              "higher")
    assert metric["source"] in SOURCES
    cells = {w["name"] for w in SPEC["workloads"]}
    assert set(metric.get("workloads", ())) <= cells
    if "bound" in metric:
        assert metric["source"] in ("host_clock", "device_trace")
        assert 0.01 <= metric["bound"] <= 0.25
    else:
        assert metric["moves"] in {m["name"] for m in SPEC["end_to_end"]}
        assert (C.BENCH / "metrics" / (metric["name"] + ".py")).exists()
        if metric["unit"] == "%" and ("roofline" in metric["name"]
                                      or "mfu" in metric["name"]):
            assert metric["better"] == "higher"


def test_pairs_of_configuration_and_traffic_are_unique():
    pairs = [(w["config"], w["traffic"]) for w in SPEC["workloads"]]
    assert len(pairs) == len(set(pairs))
