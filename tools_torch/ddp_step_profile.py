"""Where a data-parallel train step's time goes, on the card.

    python tools_torch/ddp_step_profile.py [--devices cuda:0,cuda:1]
        [--backend nccl] [--batch 32] [--res 256] [--steps 6]
        [--out chiprun_out/ddp_profile]

Spawns one rank per device (codenet_torch.parallel.launch; NCCL between
cards, or --backend gloo) and on each times ctdet ShuffleNetV2-DCN 1x
train steps at config a (256^2, 20 VOC classes) on its rows of seeded
synthetic global batches: FP32, then QAT (--wt-percentile --act_clamp),
each as the rank (global-batch BN, QAT ranges, loss counts, gradient
all-reduce) and again in the same process with no group, so that the two
compare on one card state. Per step: the host's ms to enqueue it and the
ms until the card finished (host clock, synchronised), eagerly and then
as the epoch engine's graph of the step (engine/trainer.py
make_multi_train_step: GRAPH_WARMUP eager steps, a capture, replays;
the batch's copy included; not on gloo ranks, whose collectives no
graph holds), which shows what the graph leaves to the host. Then a
torch.profiler trace of 3 steps of each (`key_averages` tables by CPU
and by CUDA time, in --out) and the host ms of one all-reduce call at 2,
513 and 2.5M floats. Prints one JSON line per rank, with the card's name
and power limit.
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


def _opt(batch, res):
    from codenet_torch import config as cfg
    opt = cfg.parse(["ctdet", "--dataset", "pascal", "--arch",
                     "shufflenetv2", "--input_res", str(res), "--batch_size",
                     str(batch)])
    return cfg.update_dataset_info_and_set_heads(
        opt, cfg.DATASET_SPECS["pascal"])


def synthetic_batches(n, batch, res, seed=0):
    """Global device-mode batches: uint8 images, colour-aug state and
    sparse ctdet targets (4 objects an image)."""
    r = np.random.RandomState(seed)
    out_res, m = res // 4, 50
    batches = []
    for _ in range(n):
        ct = r.randint(0, out_res, (batch, m, 2)).astype(np.int32)
        b = {"input_u8": r.randint(0, 256, (batch, res, res, 3))
             .astype(np.uint8),
             "aug_perm": r.randint(0, 6, batch).astype(np.int32),
             "aug_alphas": r.uniform(-0.4, 0.4, (batch, 3))
             .astype(np.float32),
             "aug_light": (r.randn(batch, 3) * 0.02).astype(np.float32),
             "hm_ct": ct, "hm_radius": r.randint(0, 4, (batch, m))
             .astype(np.int32),
             "hm_cls": r.randint(0, 20, (batch, m)).astype(np.int32),
             "reg_mask": (np.arange(m) < 4).astype(np.uint8)[None]
             .repeat(batch, 0),
             "wh": r.uniform(4, 40, (batch, m, 2)).astype(np.float32),
             "reg": r.rand(batch, m, 2).astype(np.float32)}
        b["ind"] = (ct[..., 1] * out_res + ct[..., 0]).astype(np.int64)
        batches.append(b)
    return batches


def _collective_ms(dp):
    import torch.distributed as dist
    out = {}
    for n in (2, 513, 2_500_000):
        t = torch.ones(n, device=dp.device)
        for _ in range(10):
            dist.all_reduce(t)
        torch.cuda.synchronize(dp.device)
        t0 = time.perf_counter()
        for _ in range(200):
            dist.all_reduce(t)
        host = (time.perf_counter() - t0) / 200 * 1e3
        torch.cuda.synchronize(dp.device)
        out[str(n)] = {"host_ms": host,
                       "total_ms": (time.perf_counter() - t0) / 200 * 1e3}
    return out


def _rank(dp, batch, res, steps, out_dir):
    from torch.profiler import ProfilerActivity, profile
    from codenet_torch.engine.trainer import (GRAPH_WARMUP, Trainer,
                                              batch_to_device,
                                              make_multi_train_step)
    from codenet_torch.models.layers import QuantSpec
    from codenet_torch.parallel import process_batch_slice
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    opt = _opt(batch, res)
    lo, hi = process_batch_slice(batch, dp.rank, dp.world)
    host_rows = [{k: v[lo:hi] for k, v in b.items()}
                 for b in synthetic_batches(steps, batch, res)]
    rows = [batch_to_device(b, dp.device) for b in host_rows]
    out = {"rank": dp.rank, "world": dp.world, "backend": dp.backend,
           "device": str(dp.device), "batch_per_rank": hi - lo,
           "all_reduce": _collective_ms(dp)}
    for name, qspec in (("fp32", None),
                        ("qat", QuantSpec(wt_percentile=True,
                                          act_clamp=True))):
        for mode in ("ranks", "one_process"):
            trainer = Trainer(opt, qspec=qspec, device=dp.device,
                              dp=dp if mode == "ranks" else None)
            trainer.init()
            host, total = [], []
            for b in rows:
                torch.cuda.synchronize(dp.device)
                t0 = time.perf_counter()
                trainer.train_step(b)
                host.append((time.perf_counter() - t0) * 1e3)
                torch.cuda.synchronize(dp.device)
                total.append((time.perf_counter() - t0) * 1e3)
            graphed = {}
            if mode == "one_process" or dp.graphable:
                run = make_multi_train_step(trainer.train_step,
                                            host_rows[0], dp.device)
                g_host, g_total = [], []
                for b in host_rows:
                    torch.cuda.synchronize(dp.device)
                    t0 = time.perf_counter()
                    run(b)
                    g_host.append((time.perf_counter() - t0) * 1e3)
                    torch.cuda.synchronize(dp.device)
                    g_total.append((time.perf_counter() - t0) * 1e3)
                # the replays after the one that captured
                replays = slice(GRAPH_WARMUP + 1, None)
                graphed = {
                    "graphed_host_ms": g_host, "graphed_total_ms": g_total,
                    "graphed_host_ms_median": float(np.median(
                        g_host[replays])) if g_host[replays] else None,
                    "graphed_total_ms_median": float(np.median(
                        g_total[replays])) if g_total[replays] else None}
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                for b in rows[:3]:
                    trainer.train_step(b)
                torch.cuda.synchronize(dp.device)
            events = prof.key_averages()
            cpu_us = sum(e.self_cpu_time_total for e in events)
            cuda_us = sum(getattr(e, "self_device_time_total",
                                  getattr(e, "self_cuda_time_total", 0))
                          for e in events)
            key = "{}_{}".format(name, mode)
            out[key] = {
                "host_ms": host, "total_ms": total,
                "total_ms_median": float(np.median(total[1:])),
                "profiled_self_cpu_ms_per_step": cpu_us / 3e3,
                "profiled_self_cuda_ms_per_step": cuda_us / 3e3,
                **graphed}
            with open(os.path.join(out_dir, "rank{}_{}.txt".format(
                    dp.rank, key)), "w") as f:
                f.write(events.table(sort_by="cpu_time_total",
                                     row_limit=30))
                f.write("\n\n")
                f.write(events.table(sort_by="cuda_time_total",
                                     row_limit=20))
            del trainer
    with open(os.path.join(out_dir, "rank{}.json".format(dp.rank)),
              "w") as f:
        json.dump(out, f)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--devices", default="cuda:0")
    p.add_argument("--backend", default=None)
    p.add_argument("--batch", type=int, default=32)
    p.add_argument("--res", type=int, default=256)
    p.add_argument("--steps", type=int, default=6,
                   help="steps of each kind (the graphed ones: 2 eager, "
                   "a capture, then replays)")
    p.add_argument("--out", default="chiprun_out/ddp_profile")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        sys.exit("ddp_step_profile.py times the card; none is visible")
    from codenet_torch.parallel import launch
    devices = args.devices.split(",")
    os.makedirs(args.out, exist_ok=True)
    launch(_rank, devices, backend=args.backend,
           args=(args.batch, args.res, args.steps, args.out))
    smi = os.popen("nvidia-smi --query-gpu=name,power.limit "
                   "--format=csv,noheader").read().strip()
    for k in range(len(devices)):
        with open(os.path.join(args.out, "rank{}.json".format(k))) as f:
            print(json.dumps(dict(json.load(f), card=smi)))


if __name__ == "__main__":
    main()
