"""The readings that a cell's correctness limits are set from: for each
seed, the numbers of a sound run of the program, of the control (the
reference in TF32, the precision below the configurations' float32 with
TF32 off, put in the program's place) and of the faults a cell can have
(training: half of the batch left out, the mean taken over the rest, and
the ReLUs of the backbone's units left out; serving, each planted in the
served detections as a decode would produce them: one detection's class
altered, only the best K/2 detections of a frame, its best detection
repeated K times).
A state left unchanged reads 1 by the change's measure and needs no run.

    python3 -m benchmark.readings --workload <name> --seeds 1,2,3 \\
        [--seconds 2] [--out readings.jsonl]

One process runs every seed, each with a short window at the cell's own
load; each seed's readings are one JSON line.
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

from benchmark.harness import cell as C
from benchmark.harness import compare, probe, train
from benchmark.reference.serve import dense_detections, top_detections


def training_readings(cell, rec):
    params, buffers, rows, batches = rec["inputs"]
    ref = train.reference_steps(cell, params, buffers, rows, batches)
    out = {}
    for name, kw in (("control", {"precision": "tf32"}),
                     ("half_batch", {"keep": slice(0, len(rows[0]) // 2)}),
                     ("relu_off", {"unit_relu": False})):
        got = train.reference_steps(cell, params, buffers, rows, batches,
                                    **kw)
        out[name] = dict(zip(("loss_gap", "grad_gap", "change_gap"),
                             compare.training_numbers(got, ref, params)))
    return out


def _best_first(det):
    return det[torch.argsort(det[:, 4], descending=True)]


def _altered(det, classes):
    det = det.clone()
    det[0, 5] = (det[0, 5] + 1) % classes
    return det


SERVING_FAULTS = {
    "altered": lambda det, k, classes: _altered(det, classes),
    "half_k": lambda det, k, classes: _best_first(det)[:k // 2],
    "duplicated": lambda det, k, classes:
        _best_first(det)[:1].expand(k, -1).clone(),
}


def serving_readings(cell, rec):
    params, buffers, frames, served = rec["inputs"]
    k = cell.workload["K"]
    classes = cell.config["num_classes"]
    worst = {name: dict.fromkeys(compare.SERVED, 0.0)
             for name in ("control", *SERVING_FAULTS)}
    for lo in range(0, len(frames), 32):
        chunk = frames[lo:lo + 32]
        ref = dense_detections(chunk, cell.config, params, buffers, k)
        sides = {"control": top_detections(dense_detections(
            chunk, cell.config, params, buffers, k, "tf32"), k)}
        for name, fault in SERVING_FAULTS.items():
            sides[name] = [fault(d, k, classes) for d in served[lo:lo + 32]]
        for name, dets in sides.items():
            for n, v in compare.served_numbers(dets, ref, k).items():
                worst[name][n] = max(worst[name][n], v)
    return worst


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=2.0)
    p.add_argument("--out", default="")
    args = p.parse_args(argv)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cell = C.Cell(args.workload)
    device = "cuda:0" if torch.cuda.is_available() else "cpu"
    sink = open(args.out, "a") if args.out else None
    for seed in (int(s) for s in args.seeds.split(",")):
        rec = C.run(cell, seed, args.seconds, False, device, probe.Spans())
        line = {"workload": cell.name, "seed": seed, "device": device,
                "program": {k: v["value"] for k, v in rec["checks"].items()}}
        kind = cell.workload["kind"]
        line.update(training_readings(cell, rec) if kind == "train"
                    else serving_readings(cell, rec))
        del rec
        train.free(device)
        text = json.dumps(line)
        print(text)
        sys.stdout.flush()
        if sink:
            sink.write(text + "\n")
            sink.flush()
    if sink:
        sink.close()


if __name__ == "__main__":
    main()
