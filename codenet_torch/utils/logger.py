"""Run logging (the JAX package's utils/logger.py; reference lib/logger.py).

Writes opt.txt (the full config, the torch version and the device),
a timestamped log_<time>.txt, and per-epoch scalars to scalars.jsonl (one
{"tag", "value", "step"} record per line). In a data-parallel run only
rank 0 writes (the others' loggers write nothing).
"""

from __future__ import annotations

import json
import os
import sys
import time

import torch


class Logger:
    def __init__(self, opt, device=None, rank=0):
        self.save_dir = opt.save_dir
        self.log = self.scalars = None
        if rank != 0:
            return
        os.makedirs(self.save_dir, exist_ok=True)
        debug_dir = getattr(opt, "debug_dir", None)
        if debug_dir:
            os.makedirs(debug_dir, exist_ok=True)

        time_str = time.strftime("%Y-%m-%d-%H-%M")
        args = {k: v for k, v in sorted(vars(opt).items())
                if not k.startswith("_")}
        with open(os.path.join(self.save_dir, "opt.txt"), "w") as f:
            f.write("==> torch version: {}\n".format(torch.__version__))
            f.write("==> device: {}\n".format(device))
            f.write("==> cmd:\n")
            f.write("  {}\n".format(" ".join(sys.argv)))
            f.write("==> Opt:\n")
            for k, v in args.items():
                f.write("  {}: {}\n".format(k, v))

        self.log = open(os.path.join(self.save_dir,
                                     "log_{}.txt".format(time_str)), "w")
        self.scalars = open(os.path.join(self.save_dir, "scalars.jsonl"),
                            "a")
        self.start_line = True

    def write(self, txt):
        if self.log is None:
            return
        if self.start_line:
            self.log.write("{}: {}".format(
                time.strftime("%Y-%m-%d-%H-%M"), txt))
        else:
            self.log.write(txt)
        self.start_line = txt.endswith("\n")
        self.log.flush()

    def scalar_summary(self, tag, value, step):
        if self.scalars is None:
            return
        self.scalars.write(json.dumps(
            {"tag": tag, "value": float(value), "step": int(step)}) + "\n")
        self.scalars.flush()

    def close(self):
        for f in (self.log, self.scalars):
            if f is not None:
                f.close()
