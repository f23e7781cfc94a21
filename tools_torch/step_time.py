"""FP32 and QAT train-step times of one or more checkouts, in turns, on
one card: the A/B of two commits in one call.

    python tools_torch/step_time.py ROOT [ROOT ...] [--rounds 2]

Each round runs every ROOT in order, then in reverse (A B B A for two),
each in a fresh process that imports ROOT's codenet_torch and times 8
steps of ctdet ShuffleNetV2-DCN 1x at 256^2, batch 32 (CUDA events,
median of steps 3-8; TF32 off): FP32, then QAT (--wt-percentile
--act_clamp), on seeded synthetic device-mode batches. Prints one JSON
line per run, then the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

import numpy as np

HERE = os.path.abspath(__file__)


def synthetic_batch(r, batch=32, res=256, m=50):
    out_res = res // 4
    ct = r.randint(0, out_res, (batch, m, 2)).astype(np.int32)
    b = {"input_u8": r.randint(0, 256, (batch, res, res, 3))
         .astype(np.uint8),
         "aug_perm": r.randint(0, 6, batch).astype(np.int32),
         "aug_alphas": r.uniform(-0.4, 0.4, (batch, 3)).astype(np.float32),
         "aug_light": (r.randn(batch, 3) * 0.02).astype(np.float32),
         "hm_ct": ct,
         "hm_radius": r.randint(0, 4, (batch, m)).astype(np.int32),
         "hm_cls": r.randint(0, 20, (batch, m)).astype(np.int32),
         "reg_mask": (np.arange(m) < 4).astype(np.uint8)[None]
         .repeat(batch, 0),
         "wh": r.uniform(4, 40, (batch, m, 2)).astype(np.float32),
         "reg": r.rand(batch, m, 2).astype(np.float32)}
    b["ind"] = (ct[..., 1] * out_res + ct[..., 0]).astype(np.int64)
    return b


def time_root(root):
    """The step times of the codenet_torch under `root` (this process)."""
    sys.path.insert(0, root)
    import torch
    from codenet_torch import config as cfg
    from codenet_torch.engine.trainer import Trainer, batch_to_device
    from codenet_torch.models.layers import QuantSpec
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    opt = cfg.update_dataset_info_and_set_heads(
        cfg.parse(["ctdet", "--dataset", "pascal", "--arch",
                   "shufflenetv2", "--input_res", "256", "--batch_size",
                   "32"]), cfg.DATASET_SPECS["pascal"])
    r = np.random.RandomState(0)
    batches = [batch_to_device(synthetic_batch(r), "cuda")
               for _ in range(8)]
    out = {"root": root}
    for name, qspec in (("fp32", None),
                        ("qat", QuantSpec(wt_percentile=True,
                                          act_clamp=True))):
        trainer = Trainer(opt, qspec=qspec, device="cuda")
        trainer.init()
        ms = []
        for b in batches:
            torch.cuda.synchronize()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            trainer.train_step(b)
            end.record()
            torch.cuda.synchronize()
            ms.append(start.elapsed_time(end))
        out[name + "_ms_median"] = float(np.median(ms[2:]))
        out[name + "_ms"] = ms
    return out


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("roots", nargs="+")
    p.add_argument("--rounds", type=int, default=1)
    p.add_argument("--one", action="store_true",
                   help=argparse.SUPPRESS)  # a run's own process
    args = p.parse_args(argv)
    if args.one:
        print(json.dumps(time_root(os.path.abspath(args.roots[0]))))
        return
    order = []
    for _ in range(args.rounds):
        order += args.roots + args.roots[::-1]
    for root in order:
        proc = subprocess.run([sys.executable, HERE, "--one", root],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            sys.exit(proc.stderr[-3000:])
        print(proc.stdout.strip().splitlines()[-1], flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())


if __name__ == "__main__":
    main()
