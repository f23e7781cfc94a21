"""Time the deform forward kernel at every admissible launch plan, on a card.

    python tools_torch/fwd_plan_sweep.py [--batches 2 32] [--iters 100]
        [--shapes 32x32x58 16x16x116 ...]
    python tools_torch/fwd_plan_sweep.py --kitti   # KITTI's maps, 1 and 16

For each deform shape (H x W x C; by default the model's three,
`chip_smoke.MODEL_SHAPES`), at each batch, in f32 and bf16, launches
csrc/deform_fwd.cu with every band height `rows` (the map's height,
halved down to 1, and `fwd_plan`'s own) and every slice width
`cb` (powers of two from 32 bytes up to 256 channels) whose tile fits one
block (the plan of `deform_cuda.fwd_plan_for`), and prints one JSON line
per plan: the plan, device time per launch (CUDA graph replay,
`chip_smoke.graph_time_ms`), the largest difference from the output of
`fwd_plan`'s own choice (0: every plan sums in the same order) and whether
the plan is `fwd_plan`'s. Then one line per shape, batch and dtype: the
chosen plan's time beside the fastest one's, and whether the choice is
within 5% of it.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent


def candidates(n, h, w, c, dtype, vec, chosen_rows):
    """Every (rows, cb) whose plan fits one block's shared memory, rows
    the map's height halved down to 1 and `chosen_rows`."""
    from codenet_torch.ops import deform_cuda as DC
    esize = DC._ESIZE[dtype]
    heights, rows = [chosen_rows], h
    while True:
        if rows not in heights:
            heights.append(rows)
        if rows == 1:
            break
        rows = -(-rows // 2)
    cb = max(vec, DC.FWD_MIN_SLICE_BYTES // esize)
    top = max(cb, min(DC.FWD_MAX_CB, 1 << (c - 1).bit_length()))
    widths = []
    while cb <= top:
        widths.append(cb)
        cb *= 2
    for rows in heights:
        for cb in widths:
            plan = DC.fwd_plan_for(n, h, w, c, dtype, rows, cb, vec)
            if plan["smem_bytes"] <= DC.SMEM_PER_BLOCK:
                yield plan


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--batches", type=int, nargs="+", default=[2, 32])
    parser.add_argument("--iters", type=int, default=100)
    parser.add_argument("--shapes", nargs="+", default=None,
                        help="HxWxC maps (default: the model's three)")
    parser.add_argument("--kitti", action="store_true",
                        help="chip_smoke.KITTI_SHAPES (ddd at 384x1280) at "
                        "its served batch (1) and train batch")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        sys.exit("fwd_plan_sweep.py needs a CUDA card; none is visible")
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from codenet_torch.ops import deform_cuda as DC

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip(), flush=True)
    chosen_plan = DC.fwd_plan
    gen = torch.Generator().manual_seed(cs.SEED)
    shapes = ([tuple(int(v) for v in sh.split("x")) for sh in args.shapes]
              if args.shapes else cs.MODEL_SHAPES)
    if args.kitti:
        shapes = cs.KITTI_SHAPES
        args.batches = [1, cs.KITTI_TRAIN_BATCH]
    for shape in shapes:
        for n in args.batches:
            for dtype in (torch.float32, torch.bfloat16):
                x, s, wt = cs._case(shape, n, dtype, gen)
                chosen = chosen_plan(n, *shape, dtype)
                ref = DC.codesign_deform_conv_fast(x, s, wt)
                times = []
                for plan in candidates(n, *shape, dtype, chosen["vec"],
                                       chosen["rows"]):
                    DC.fwd_plan = lambda *_, plan=plan, **__: plan
                    got = DC.codesign_deform_conv_fast(x, s, wt)
                    us = cs.graph_time_ms(
                        lambda: DC.codesign_deform_conv_fast(x, s, wt),
                        args.iters) * 1e3
                    DC.fwd_plan = chosen_plan
                    is_chosen = plan == chosen
                    times.append((us, plan, is_chosen))
                    print(json.dumps({
                        "shape": list(shape), "n": n,
                        "dtype": str(dtype).split(".")[-1], **plan,
                        "us": us,
                        "diff_vs_chosen": float((got.float() - ref.float())
                                                .abs().max()),
                        "chosen": is_chosen}), flush=True)
                best = min(times, key=lambda t: t[0])
                mine = next(t for t in times if t[2])
                print(json.dumps({
                    "summary": True, "shape": list(shape), "n": n,
                    "dtype": str(dtype).split(".")[-1],
                    "chosen": {k: mine[1][k] for k in ("rows", "cb")},
                    "chosen_us": mine[0],
                    "fastest": {k: best[1][k] for k in ("rows", "cb")},
                    "fastest_us": best[0], "ratio": mine[0] / best[0],
                    "within_5pct": mine[0] <= 1.05 * best[0]}), flush=True)


if __name__ == "__main__":
    main()
