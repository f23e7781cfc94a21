"""A copy of the benchmark in a temporary directory with tiny cells added
as fixture files (configurations, traffic mixes, cells' limits, their
BENCHMARK.json entries, an architecture module), which the harness finds
by name as it finds the real ones. The tiny cells are the real ones at
64x64, batch 4, 40 frames, on the CPU: on ShuffleNetV2 1x (`tiny_a`),
with a W4A8 QAT fine-tune of the training cell (tools_torch/
run_configs_ae.py's qat_finetune recipe) held to its limits; and on the
program's res_18 (`tiny_res`), an architecture that the benchmark does
not hold, added by its reference module `arch/res.py` beside this file,
copied into the checkout's `benchmark/reference/arch/`."""

from __future__ import annotations

import json
import os
import shutil
from pathlib import Path

from benchmark.harness import cell as C
from benchmark.reference import arch

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
RES = 64
REAL_CONFIG = BENCH / "configs" / "codenet_d_2x512.json"
# ShuffleNetV2's keys, which a configuration of another architecture has
# none of
SHUFFLENET_KEYS = ("w2", "maxpool", "widths", "neck_widths")

TRAIN = ("d_train_fp32_b32", "train_voc0712_fp32_b32")
SERVE = ("d_serve_flip_b32", "serve_voc07test_flip_b32_r16")
# cell: (configuration, the real cell and traffic it copies)
TINY = {"tiny_train": ("tiny_a", *TRAIN),
        "tiny_qat": ("tiny_a", *TRAIN),
        "tiny_serve": ("tiny_a", *SERVE),
        "tiny_res_train": ("tiny_res", *TRAIN),
        "tiny_res_serve": ("tiny_res", *SERVE)}
QAT = {"lr": 1.25e-6, "quant": {"w_bit": 4, "a_bit": 8,
                                "wt_percentile": True, "act_clamp": True}}


def configs():
    """{name: configuration} of the fixture's configurations."""
    real = json.loads(REAL_CONFIG.read_text())
    res = {k: v for k, v in real.items() if k not in SHUFFLENET_KEYS}
    # macs: the program's res_18 at 64x64 under FlopCounterMode
    res.update(name="tiny_res", arch="res_18", input_res=RES,
               macs_per_image=353959936, reduced=["input_res"])
    return {"tiny_a": dict(real, name="tiny_a", input_res=RES, w2=False,
                           reduced=["input_res", "w2"]),
            "tiny_res": res}


def fixture_archs():
    """The architecture modules kept beside this file."""
    return sorted((BENCH / "tests" / "arch").glob("*.py"))


def make(tmp, batch=4):
    """Write the copy under `tmp` and return its root."""
    root = Path(tmp) / "checkout"
    shutil.copytree(BENCH, root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "_cache"))
    os.symlink(ROOT / "codenet_torch", root / "codenet_torch")
    for path in fixture_archs():
        shutil.copy(path, root / "benchmark" / "reference" / "arch")
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    for name, cfg in configs().items():
        (root / "benchmark" / "configs" / (name + ".json")).write_text(
            json.dumps(cfg))
        spec["configs"].append({"name": name, "source": "fixture",
                                "file": "benchmark/configs/{}.json".format(
                                    name),
                                "reduced": cfg["reduced"], "why": "a test"})
    side = RES - RES // 16
    for cell, (config, real, traffic) in TINY.items():
        mix = C.traffic_mix(BENCH, traffic)
        mix["frames"].update(count=40, sizes=[[side, RES + RES // 4, 0.7],
                                              [RES + RES // 4, side, 0.3]])
        mix["batch"] = batch
        if cell == "tiny_qat":
            mix.update(QAT)
        if mix["kind"] == "train":
            mix["loader_threads"] = 2
        else:
            mix.update(raw_buffer_hw=[2 * RES, 2 * RES], sample_requests=2)
        (root / "benchmark" / "traffic" / (cell + ".json")
         ).write_text(json.dumps(mix))
        shutil.copy(BENCH / "workloads" / (real + ".json"),
                    root / "benchmark" / "workloads" / (cell + ".json"))
        spec["workloads"].append({"name": cell, "config": config,
                                  "traffic": cell, "chips": 1,
                                  "why": "a test"})
        for m in spec["end_to_end"] + spec["per_layer"]:
            if real in m.get("workloads", ()):
                m["workloads"].append(cell)
    (root / "BENCHMARK.json").write_text(json.dumps(spec, indent=1))
    return root


def arch_configs(root):
    """{family: (module, configuration)} of every architecture module in
    the checkout at `root`: each with the first configuration of its
    family that BENCHMARK.json lists, a fixture's first, at RES x RES."""
    spec = json.loads((root / "BENCHMARK.json").read_text())
    entries = sorted(spec["configs"],
                     key=lambda c: not c["name"].startswith("tiny_"))
    out = {}
    for path in sorted((root / "benchmark" / "reference" / "arch")
                       .glob("*.py")):
        if path.stem == "__init__":
            continue
        cfg = next(cfg for cfg in (json.loads((root / c["file"]).read_text())
                                   for c in entries)
                   if arch.family(cfg["arch"]) == path.stem)
        cfg.update(input_res=RES, input_hw=[RES, RES])
        out[path.stem] = (arch.load(cfg["arch"], root), cfg)
    return out
