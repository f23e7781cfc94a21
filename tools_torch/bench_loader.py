#!/usr/bin/env python
"""Host data-loader throughput: the ctdet sampler's img/s against the
worker count.

Times the port's whole host path, codenet_torch/data/loader.py over the
ctdet sampler (image read, affine warp, target drawing), on a synthetic
VOC set of 640x480 PNG frames that tools_torch/synthetic_data.py writes
into a temporary directory. One warm epoch, then `--epochs` timed ones
per worker count; one JSON line per count:

  python tools_torch/bench_loader.py [--input_res 256] [--batch 128] \\
      [--images 64] [--epochs 3] [--workers 1,2,4,8]

The card's step time (PERF.md) is what the loader has to keep up with:
img/s here above batch / step seconds leaves the card waiting for nothing.
"""

import argparse
import json
import os
import shutil
import sys
import tempfile
import time

TOOLS = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(TOOLS))
sys.path.insert(0, TOOLS)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--input_res", type=int, default=256)
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--images", type=int, default=64)
    ap.add_argument("--epochs", type=int, default=3)
    ap.add_argument("--workers", default="1,2,4,8")
    ap.add_argument("--img_w", type=int, default=640)
    ap.add_argument("--img_h", type=int, default=480)
    args = ap.parse_args(argv)

    from codenet_torch import config as cfg
    from codenet_torch.data.datasets import get_dataset
    from codenet_torch.data.loader import DataLoader
    from codenet_torch.engine.trainer import batch_size_of
    from synthetic_data import make_voc_dataset

    print(json.dumps({"host_cpus": os.cpu_count()}), flush=True)
    root = tempfile.mkdtemp(prefix="bench_loader_")
    try:
        # drop_last needs at least one whole batch
        n_imgs = max(args.images, args.batch)
        make_voc_dataset(root, num_images=n_imgs, img_w=args.img_w,
                         img_h=args.img_h)
        opt = cfg.update_dataset_info_and_set_heads(cfg.parse(
            ["ctdet", "--dataset", "pascal", "--arch", "shufflenetv2",
             "--input_res", str(args.input_res), "--batch_size",
             str(args.batch), "--data_dir", root]),
            cfg.DATASET_SPECS["pascal"])
        ds = get_dataset("pascal", "ctdet")(opt, "train")
        for nw in (int(w) for w in args.workers.split(",")):
            loader = DataLoader(ds, args.batch, shuffle=True,
                                num_workers=nw, seed=0)
            for _ in loader:  # warm: page cache, thread pool
                pass
            t0 = time.perf_counter()
            n = 0
            for _ in range(args.epochs):
                for batch in loader:
                    n += batch_size_of(batch)
            dt = time.perf_counter() - t0
            print(json.dumps({"workers": nw, "images": n, "seconds": dt,
                              "img_per_s": n / dt}), flush=True)
    finally:
        shutil.rmtree(root, ignore_errors=True)


if __name__ == "__main__":
    main()
