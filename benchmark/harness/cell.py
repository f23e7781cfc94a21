"""Finding a cell's pieces by name, running it, and its result line.

`BENCHMARK.json` names each cell's configuration and traffic mix; their
files are `benchmark/configs/<config>.json` (the path the entry gives),
`benchmark/traffic/<traffic>.json` (a mix that names a `base` mix takes
its parameters and sets its own over them: mixes that differ in their
rate alone share one file of frames), and the cell's correctness limits
`benchmark/workloads/<cell>.json`. Each per-layer metric is the reader
`benchmark/metrics/<metric>.py`. A cell, mix, configuration or metric is
added by adding files and entries; no code names one.
"""

from __future__ import annotations

import importlib.util
import json
import statistics
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
KINDS = ("train", "serve")


class Cell:
    def __init__(self, name, root=ROOT):
        root = Path(root)
        spec = json.loads((root / "BENCHMARK.json").read_text())
        entry = next((w for w in spec["workloads"] if w["name"] == name),
                     None)
        if entry is None:
            raise KeyError("no workload {!r} in BENCHMARK.json".format(name))
        conf = next(c for c in spec["configs"] if c["name"] == entry["config"])
        bench = root / "benchmark"
        self.name = name
        self.root = root
        self.entry = entry
        self.chips = entry["chips"]
        self.config = json.loads((root / conf["file"]).read_text())
        res = self.config["input_res"]
        self.config.setdefault("input_hw", [res, res])
        self.workload = traffic_mix(bench, entry["traffic"])
        self.workload.update(json.loads(
            (bench / "workloads" / (name + ".json")).read_text()))
        if self.workload["kind"] not in KINDS:
            raise ValueError("traffic kind {!r} is none of {}".format(
                self.workload["kind"], KINDS))
        self.end_to_end = [m for m in spec["end_to_end"]
                           if name in m.get("workloads", [name])]
        reported = {m["name"] for m in self.end_to_end}
        self.per_layer = [m for m in spec["per_layer"]
                          if (name in m["workloads"] if "workloads" in m
                              else m["moves"] in reported)]
        self.metric_dir = bench / "metrics"

    def reader(self, metric):
        path = self.metric_dir / (metric + ".py")
        spec = importlib.util.spec_from_file_location(
            "benchmark_metric_" + metric.replace(".", "_"), path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod.read


def traffic_mix(bench, name):
    """The parameters of traffic mix `name`, its `base` mix's under its
    own."""
    mix = json.loads((bench / "traffic" / (name + ".json")).read_text())
    base = mix.pop("base", None)
    if base is None:
        return mix
    out = traffic_mix(bench, base)
    out.update(mix)
    return out


def run(cell, seed, seconds, traced, device, spans, faults=()):
    """The record of one run of the cell, from its kind's runner."""
    from . import serve, train
    runner = {"train": train, "serve": serve}[cell.workload["kind"]]
    return runner.run(cell, seed, seconds, spans, traced, device, faults)


def end_to_end(cell, record, setup_s):
    """{name: value} of the cell's end-to-end metrics from a run's record
    (host clock over the window)."""
    window = record["window_s"]
    values = {"setup_s": setup_s}
    if cell.workload["kind"] == "train":
        values["train_img_per_s"] = record["images"] / window
    else:
        values["serve_img_per_s"] = record["images"] / window
        lat = record["latencies_s"]
        if len(lat) >= 2:
            values["serve_p95_ms"] = 1e3 * statistics.quantiles(
                lat, n=20, method="inclusive")[-1]
    return {m["name"]: values[m["name"]] for m in cell.end_to_end
            if m["name"] in values}


class Reading:
    """What a metric reader sees of a run: the cell, its record, the
    bench spans, the trace's summary (None untraced), the end-to-end
    values, the card's name."""

    def __init__(self, cell, record, spans, trace, values, card):
        self.cell = cell
        self.record = record
        self.spans = spans
        self.trace = trace
        self.values = values
        self.card = card


def per_layer(cell, reading):
    out = {}
    for m in cell.per_layer:
        value = cell.reader(m["name"])(reading)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out
