"""A copy of the benchmark in a temporary directory with tiny cells added
as fixture files (a configuration, traffic mixes, cells' limits, their
BENCHMARK.json entries), which the harness finds by name as it finds the
real ones. The tiny cells are the real ones on ShuffleNetV2 1x at 64x64,
batch 4, 40 frames, on the CPU, and a W4A8 QAT fine-tune of the training
cell (tools_torch/run_configs_ae.py's qat_finetune recipe), held to its limits."""

from __future__ import annotations

import json
import os
import shutil
from pathlib import Path

from benchmark.harness import cell as C

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent

TINY = {"tiny_train": ("d_train_fp32_b32", "train_voc0712_fp32_b32"),
        "tiny_qat": ("d_train_fp32_b32", "train_voc0712_fp32_b32"),
        "tiny_serve": ("d_serve_flip_b32", "serve_voc07test_flip_b32_r16")}
QAT = {"lr": 1.25e-6, "quant": {"w_bit": 4, "a_bit": 8,
                                "wt_percentile": True, "act_clamp": True}}


def make(tmp, res=64, batch=4):
    """Write the copy under `tmp` and return its root."""
    root = Path(tmp) / "checkout"
    shutil.copytree(BENCH, root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "_cache"))
    os.symlink(ROOT / "codenet_torch", root / "codenet_torch")
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    cfg = json.loads((BENCH / "configs" / "codenet_d_2x512.json").read_text())
    cfg.update(name="tiny_a", input_res=res, w2=False)
    (root / "benchmark" / "configs" / "tiny_a.json").write_text(
        json.dumps(cfg))
    spec["configs"].append({"name": "tiny_a", "source": "fixture",
                            "file": "benchmark/configs/tiny_a.json",
                            "reduced": ["input_res", "w2"],
                            "why": "a test"})
    side = res - res // 16
    for cell, (real, traffic) in TINY.items():
        mix = C.traffic_mix(BENCH, traffic)
        mix["frames"].update(count=40, sizes=[[side, res + res // 4, 0.7],
                                              [res + res // 4, side, 0.3]])
        mix["batch"] = batch
        if cell == "tiny_qat":
            mix.update(QAT)
        if mix["kind"] == "train":
            mix["loader_threads"] = 2
        else:
            mix.update(raw_buffer_hw=[2 * res, 2 * res], sample_requests=2)
        (root / "benchmark" / "traffic" / (cell + ".json")
         ).write_text(json.dumps(mix))
        shutil.copy(BENCH / "workloads" / (real + ".json"),
                    root / "benchmark" / "workloads" / (cell + ".json"))
        spec["workloads"].append({"name": cell, "config": "tiny_a",
                                  "traffic": cell, "chips": 1,
                                  "why": "a test"})
        for m in spec["end_to_end"] + spec["per_layer"]:
            if real in m.get("workloads", ()):
                m["workloads"].append(cell)
    (root / "BENCHMARK.json").write_text(json.dumps(spec, indent=1))
    return root
