"""Time the deform backward kernel at every slice width cb, on a CUDA card.

    python tools_torch/bwd_plan_sweep.py [--batch 32] [--iters 50]
        [--shapes 32x32x58 16x16x116 ...]
    python tools_torch/bwd_plan_sweep.py --kitti   # KITTI's maps, batch 16

For each backward shape (H x W x C; by default `chip_smoke.py`'s), in f32
and bf16, launches
csrc/deform_bwd.cu with every cb whose shared memory fits one block (the
plan of `deform_cuda.bwd_plan_for`) and prints one JSON line per launch
plan: cb, threads, shared bytes, blocks, device time per launch (CUDA
graph replay, `chip_smoke.graph_time_ms`), the worst error of dx, ds and
dw against cb = `bwd_plan`'s choice relative to each output's max, and
whether that cb is `bwd_plan`'s. It says whether `bwd_plan`'s rule picks
the fastest cb the card offers.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--batch", type=int, default=32)
    parser.add_argument("--iters", type=int, default=50)
    parser.add_argument("--shapes", nargs="+", default=None,
                        help="HxWxC maps (default: chip_smoke.BWD_SHAPES)")
    parser.add_argument("--kitti", action="store_true",
                        help="chip_smoke.KITTI_SHAPES (ddd at 384x1280) at "
                        "its train batch, chip_smoke.KITTI_TRAIN_BATCH")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        sys.exit("bwd_plan_sweep.py needs a CUDA card; none is visible")
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from codenet_torch.ops import deform_cuda as DC

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip(), flush=True)
    chosen_plan = DC.bwd_plan
    gen = torch.Generator().manual_seed(cs.SEED)
    shapes = ([tuple(int(v) for v in sh.split("x")) for sh in args.shapes]
              if args.shapes else cs.BWD_SHAPES)
    if args.kitti:
        shapes, args.batch = cs.KITTI_SHAPES, cs.KITTI_TRAIN_BATCH
    for shape in shapes:
        h, w, c = shape
        for dtype in (torch.float32, torch.bfloat16):
            x, s, wt, g = cs._bwd_case(shape, args.batch, dtype, gen)
            chosen = chosen_plan(args.batch, h, w, c)["cb"]
            ref = DC.codesign_deform_conv_bwd(x, s, wt, g)
            cb = 1
            while cb <= min(DC.BWD_MAX_CB, 1 << (c - 1).bit_length()):
                plan = DC.bwd_plan_for(args.batch, h * w, c, cb)
                cb *= 2
                if plan["smem_bytes"] > DC.SMEM_PER_BLOCK:
                    continue
                DC.bwd_plan = lambda *_, plan=plan: plan
                got = DC.codesign_deform_conv_bwd(x, s, wt, g)
                ms = cs.graph_time_ms(
                    lambda: DC.codesign_deform_conv_bwd(x, s, wt, g),
                    args.iters)
                DC.bwd_plan = chosen_plan
                err = max(float((a.float() - b.float()).abs().max())
                          / float(b.float().abs().max())
                          for a, b in zip(got, ref))
                print(json.dumps({
                    "shape": list(shape), "n": args.batch,
                    "dtype": str(dtype).split(".")[-1], **plan,
                    "us": ms * 1e3, "rel_err_vs_chosen": err,
                    "chosen": plan["cb"] == chosen}), flush=True)


if __name__ == "__main__":
    main()
