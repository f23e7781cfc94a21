#!/usr/bin/env python
"""Micro-benchmarks of the port's layers, one JSON line per entry:

  python tools_torch/layer_bench.py deform   # the deform kernels, forward
                                             # and forward + backward, at
                                             # the four deconv shapes
  python tools_torch/layer_bench.py heads    # fused against per-head heads
  python tools_torch/layer_bench.py decode   # ctdet_decode alone
  python tools_torch/layer_bench.py all [--device cpu] [--batch 2] ...

Each line is {"name", "ms", "img_per_s"?} (img/s where the entry has a
batch). On a card (the default) each entry is captured once in a CUDA
graph and timed with CUDA events over `--iters` replays, so the host's
dispatch drops out; with --device cpu it is timed on the host clock over
`--iters` calls (a check that the entries run, not a measurement of the
port). The deform entries call codesign_deform_conv_fast, which launches
csrc/deform_fwd.cu and deform_bwd.cu on a card and runs their plain
versions on the CPU.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

# the three deconv maps of config a at 256^2 and the last of 512^2
DEFORM_SHAPES = [("deconv0 8x8x1024", 8, 8, 1024),
                 ("deconv1 16x16x256", 16, 16, 256),
                 ("deconv2 32x32x128", 32, 32, 128),
                 ("512-deconv2 64x64x128", 64, 64, 128)]
HEADS = {"hm": 20, "wh": 2, "reg": 2}


def timer(fn, device, iters, warmup):
    """ms per call of fn: on a card, graph replays timed with CUDA events
    (warm-up calls on a side stream first, as capture requires); on the
    CPU, the host clock."""
    if device.type != "cuda":
        for _ in range(warmup):
            fn()
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        return (time.perf_counter() - t0) * 1e3 / iters
    side = torch.cuda.Stream(device)
    side.wait_stream(torch.cuda.current_stream(device))
    with torch.cuda.stream(side):
        for _ in range(max(warmup, 1)):
            fn()
    torch.cuda.current_stream(device).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize(device)
    start.record()
    for _ in range(iters):
        graph.replay()
    end.record()
    torch.cuda.synchronize(device)
    return start.elapsed_time(end) / iters


def emit(name, ms, batch=None):
    row = {"name": name, "ms": ms}
    if batch:
        row["img_per_s"] = batch / ms * 1e3
    print(json.dumps(row), flush=True)


def bench_deform(args, device):
    from codenet_torch.ops.deform_cuda import codesign_deform_conv_fast
    dtype = getattr(torch, args.dtype)
    rng = np.random.RandomState(0)
    for name, h, w, c in DEFORM_SHAPES:
        x = torch.from_numpy(rng.randn(args.batch, h, w, c).astype(
            np.float32)).to(device, dtype)
        s = torch.from_numpy(rng.uniform(-2, 3, (args.batch, h, w, 1))
                             .astype(np.float32)).to(device)
        wk = torch.from_numpy((rng.randn(3, 3, 1, c) * 0.2).astype(
            np.float32)).to(device, dtype)
        with torch.no_grad():
            emit("deform_fwd[{}] {}".format(args.dtype, name),
                 timer(lambda: codesign_deform_conv_fast(x, s, wk), device,
                       args.iters, args.warmup), args.batch)
        xg, sg, wg = (t.detach().requires_grad_() for t in (x, s, wk))

        def step():
            out = codesign_deform_conv_fast(xg, sg, wg)
            torch.autograd.grad(out.float().sum(), (xg, sg, wg))
        emit("deform_fwd+bwd[{}] {}".format(args.dtype, name),
             timer(step, device, args.iters, args.warmup), args.batch)


def _model(args, device):
    from codenet_torch.models import create_model
    dtype = torch.bfloat16 if args.dtype == "bfloat16" else None
    return create_model("shufflenetv2", HEADS, 64, dtype=dtype,
                        device=device,
                        generator=torch.Generator().manual_seed(0))


def bench_heads(args, device):
    from codenet_torch.models.fused_heads import apply_fused_heads
    from codenet_torch.models.layers import nhwc
    model = _model(args, device)
    x = torch.from_numpy(np.random.RandomState(0).randn(
        args.batch, 4 * args.res, 4 * args.res, 3).astype(np.float32)
    ).to(device)
    with torch.no_grad():
        neck = model(x, return_neck=True)
        emit("heads fused", timer(lambda: apply_fused_heads(model, neck),
                                  device, args.iters, args.warmup),
             args.batch)
        emit("heads per-head", timer(
            lambda: {n: nhwc(getattr(model, n)(neck)).float()
                     for n, _ in model.heads},
            device, args.iters, args.warmup), args.batch)
        emit("net neck only", timer(lambda: model(x, return_neck=True),
                                    device, args.iters, args.warmup),
             args.batch)
        emit("net full (fused heads)", timer(
            lambda: apply_fused_heads(model, model(x, return_neck=True)),
            device, args.iters, args.warmup), args.batch)


def bench_decode(args, device, classes=20, k=100):
    from codenet_torch.models import decode as D
    rng = np.random.RandomState(0)
    shape = (args.batch, args.res, args.res)
    hm = torch.from_numpy(rng.rand(*shape, classes).astype(np.float32))
    wh = torch.from_numpy(rng.rand(*shape, 2).astype(np.float32))
    reg = torch.from_numpy(rng.rand(*shape, 2).astype(np.float32))
    hm, wh, reg = (t.to(device) for t in (hm, wh, reg))
    emit("ctdet_decode", timer(lambda: D.ctdet_decode(hm, wh, reg, k=k),
                               device, args.iters, args.warmup), args.batch)


MODES = {"deform": bench_deform, "heads": bench_heads,
         "decode": bench_decode}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("mode", nargs="?", default="all",
                    choices=sorted(MODES) + ["all"])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--res", type=int, default=64,
                    help="heads and decode: the output map's side")
    ap.add_argument("--dtype", default="bfloat16",
                    choices=["float32", "bfloat16"])
    ap.add_argument("--iters", type=int, default=50)
    ap.add_argument("--warmup", type=int, default=10)
    args = ap.parse_args(argv)
    from codenet_torch import resolve_device
    device = resolve_device(args.device)
    for name, fn in MODES.items():
        if args.mode in (name, "all"):
            fn(args, device)


if __name__ == "__main__":
    main()
