"""A training cell: the program's `Trainer.run_epoch` on its graphed epoch
engine, fed by its DataLoader over the device image cache, measured over
a window of time.

Set-up builds the trainer once from the seeded state, drives it through
its first three steps by the window's own call (`run_epoch`) and feed (the
loader), keeps their losses, Adam's first moments after the first and the
weights after the third, replays a few steps more and opens the window.
After the window, with the program's state freed, the reference takes the
same three steps on the same rows and the run is judged by
`compare.training`.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from ..reference.train import Trainer as RefTrainer
from . import compare, probe, traffic, weights

FIRST_STEPS = 3
WARM_REPLAYS = 2
TRACED_STEPS = 24
CALIBRATION_FRAMES = 8


class Feed:
    """The iterable handed to `run_epoch`: batches from the loader, epoch
    after epoch, the wait in next() timed as the span `loader_wait` and
    the rest of a step as `engine`; stops after `limit` batches or at
    `deadline` (host clock)."""

    def __init__(self, loader, spans, window=None):
        self.loader = loader
        self.it = iter(loader)
        self.spans = spans
        self.window = window
        self.limit = None
        self.deadline = None
        self.count = 0
        self._engine = None

    def next_batch(self):
        try:
            return next(self.it)
        except StopIteration:
            self.it = iter(self.loader)
            return next(self.it)

    def close(self):
        self.it.close()

    def take(self, limit=None, deadline=None):
        self.limit, self.deadline = limit, deadline
        return self

    def __len__(self):
        return self.limit if self.limit is not None else 1 << 30

    def __iter__(self):
        n = 0
        while self.limit is None or n < self.limit:
            if self.deadline is not None \
                    and time.perf_counter() >= self.deadline:
                break
            self._close_engine()
            with self.spans.span("loader_wait"):
                batch = self.next_batch()
            if self.window is not None:
                self.window.step()
            n += 1
            self.count += 1
            self._engine = self.spans.span("engine")
            self._engine.__enter__()
            yield batch
        self._close_engine()

    def _close_engine(self):
        if self._engine is not None:
            self._engine.__exit__(None, None, None)
            self._engine = None


def program_opt(cfg, wl, seed):
    """The program's options for a training cell, as its CLIs parse them."""
    from codenet_torch import config as C
    args = ["ctdet", "--dataset", cfg["dataset"], "--arch", cfg["arch"],
            "--head_conv", str(cfg["head_conv"]),
            "--input_res", str(cfg["input_res"]),
            "--batch_size", str(wl["batch"]),
            "--num_workers", str(wl["loader_threads"]),
            "--lr", repr(wl["lr"]), "--seed", str(seed), "--device_cache",
            "--data_dir", "unused"]
    if cfg["w2"]:
        args.append("--w2")
    if wl.get("quant"):
        args += ["--resume-quantize", "--w-bit", str(wl["quant"]["w_bit"]),
                 "--a-bit", str(wl["quant"]["a_bit"])]
        args += ["--wt-percentile"] if wl["quant"]["wt_percentile"] else []
        args += ["--act_clamp"] if wl["quant"]["act_clamp"] else []
    opt = C.parse(args)
    return C.update_dataset_info_and_set_heads(
        opt, C.DATASET_SPECS[cfg["dataset"]])


def in_memory_dataset(opt, gt):
    """The program's ctdet dataset (its Pascal VOC class with the ctdet
    sampler) over annotations held in memory."""
    from codenet_torch.data.datasets import BaseDataset, get_dataset
    base = get_dataset(opt.dataset, "ctdet")

    class Frames(base):
        def __init__(self):
            self.annot_path = gt  # the index takes a dict as it is
            self._valid_ids = np.arange(1, opt.num_classes + 1,
                                        dtype=np.int32)
            self.cat_ids = {v: i for i, v in enumerate(self._valid_ids)}
            BaseDataset.__init__(self, opt, "train")
    return Frames()


def _first_gradients(trainer):
    """Each parameter's first gradient as Adam took it: its first moment
    after one step over 1 - beta1 (zero where Adam holds no state)."""
    state = trainer.optimizer.state
    beta1 = trainer.optimizer.param_groups[0]["betas"][0]
    out = {}
    for name, p in trainer.model.named_parameters():
        st = state.get(p, {})
        out[name] = (st["exp_avg"].detach().clone() / (1 - beta1)
                     if "exp_avg" in st else torch.zeros_like(p))
    return out


def run(cell, seed, seconds, spans, traced, device, faults=()):
    """One run of a training cell: returns the record the metrics and the
    result line read. `faults` plants the harness tests' faults into the
    program."""
    from codenet_torch.data.loader import DataLoader
    from codenet_torch.engine.trainer import Trainer
    from codenet_torch.models.layers import qspec_from_opt

    cfg, wl = cell.config, cell.workload
    data_seed, weight_seed, loader_seed = traffic.seeds(seed, 3)
    opt = program_opt(cfg, wl, loader_seed)
    rng = np.random.RandomState(data_seed)
    dims = traffic.frame_sizes(wl["frames"], rng)
    gt = traffic.annotations(wl["frames"], dims, rng, cfg["num_classes"])
    cache = traffic.pixels(dims, data_seed, device)
    dataset = in_memory_dataset(opt, gt)
    dataset._image_cache_dims = dims

    quant = wl.get("quant")
    params, buffers = weights.make(cfg, weight_seed, device, bool(quant))
    buffers = weights.calibrated(cfg, params, buffers,
                                 cache[:CALIBRATION_FRAMES],
                                 dims[:CALIBRATION_FRAMES], quant)
    reset_peak_memory(device)
    trainer = Trainer(opt, qspec=qspec_from_opt(opt) if quant else None,
                      device=device)
    compare.load_state(trainer.model, weights.state_dict(params, buffers))
    trainer.init()
    trainer.image_cache = cache
    for fault in faults:
        fault(trainer)
    loader = DataLoader(dataset, wl["batch"], shuffle=True,
                        num_workers=wl["loader_threads"], seed=loader_seed)
    window = probe.Window(traced, TRACED_STEPS)
    window.prepare(device)
    feed = Feed(loader, spans)

    first, losses, grads = [], [], None
    for k in range(FIRST_STEPS):
        batch = feed.next_batch()
        first.append(batch)
        losses.append(trainer.run_epoch("train", 1, [batch])["loss"])
        if k == 0:
            grads = _first_gradients(trainer)
    after = {n: p.detach().clone()
             for n, p in trainer.model.named_parameters()}
    trainer.run_epoch("train", 1, feed.take(WARM_REPLAYS))
    sync(device)

    spans.on = True
    feed.window = window
    with window:
        t0, wall0 = time.perf_counter(), time.time()
        feed.count = 0
        stats = trainer.run_epoch("train", 1,
                                  feed.take(deadline=t0 + seconds))
        sync(device)
        t1 = time.perf_counter()
    spans.on = False
    steps = feed.count
    feed.close()
    record = {
        "window_s": t1 - t0, "steps": steps, "images": steps * wl["batch"],
        "attempted": steps,
        "failed": 0 if np.isfinite(stats.get("loss", np.nan)) else steps,
        "memory_peak_bytes": peak_memory(device),
        "trace": window.events(), "window_start_wall": wall0}

    rows = [cache[torch.as_tensor(b["img_idx"], device=device).long()]
            .clone() for b in first]
    del trainer, cache, loader, feed
    free(device)
    program = {"losses": losses, "first_grads": grads, "after": after}
    ref = reference_steps(cell, params, buffers, rows, first)
    record["checks"] = compare.training(program, ref, params,
                                        wl["limits"])
    record["inputs"] = (params, buffers, rows, first)
    return record


def reference_steps(cell, params, buffers, rows, batches, precision="f32",
                    keep=None, unit_relu=True):
    """The reference's first steps on the rows and batches the program
    took: {losses, first_grads, after}. `keep` and `unit_relu=False` plant
    the readings' faults (reference.train.Trainer)."""
    cfg, wl = cell.config, cell.workload
    ref = RefTrainer(cfg, params, buffers, wl["lr"], precision,
                     wl.get("quant"), unit_relu)
    losses = [ref.step(r, b, keep) for r, b in zip(rows, batches)]
    return {"losses": losses, "first_grads": ref.first_grads,
            "after": ref.params}


def sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def reset_peak_memory(device):
    """From here on the peak counts the program's run, with the cell's
    data resident, and not the set-up's passing allocations (the serving
    pool is made on the card, then copied to the host)."""
    if torch.device(device).type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)


def peak_memory(device):
    if torch.device(device).type == "cuda":
        return int(torch.cuda.max_memory_allocated(device))
    return 0


def free(device):
    import gc
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
