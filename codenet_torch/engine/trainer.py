"""Training engine (the JAX package's engine/trainer.py; reference
lib/trains/base_trainer.py and the per-task trains/{ctdet,ddd,
multi_pose,exdet}.py).

One train step: model input on the device (colour aug + normalisation of
the uint8 batch, or of the rows of the device image cache warped on the
card, --device_cache) -> sparse ctdet targets rendered on the device (the
dense targets of the other tasks arrive as their samplers made them) ->
forward -> loss -> backward -> Adam. FP32 training runs the model in train mode (BN
on batch statistics, running statistics updated); QAT (a `QuantSpec`)
runs it against frozen folded BN with `update_stats=True`, so only the
activation-range EMA moves (the JAX step's `train=False,
update_stats=True`). `torch.optim.Adam` is optax.adam: same moments, same
bias correction, eps outside the square root. With ``--dtype bfloat16``
the model's convs take bf16 operands (models/layers.py); its heads, the
loss, the parameters and Adam's state stay f32.

FP32 and bf16 ShuffleNetV2 steps run the heads fused
(models/fused_heads.py: one widened pipeline over the neck, the JAX
train step's path) unless the trainer is built with fuse_heads=False;
the val step runs them fused always, as in the JAX package.

The epoch loop is the JAX package's: the per-step path, with its hooks
(--debug renders and --test's decoded val results, engine/train_hooks.py;
the --eval_oracle_* probes, make_oracle_val_step), and, where no hook
watches the steps (phase train, no --debug, no --test results,
print_iter <= 0, CODENET_SCAN_EPOCH "1", the default), the graphed epoch
engine (`_run_epoch_scan`, the JAX trainer's scan engine): each batch
takes its step as the loader delivers it, on a card as a replay of one
CUDA graph of the whole train step, forward to Adam's update
(`make_multi_train_step`), over static input buffers that the batch is
copied into; the stats stay on the card and are read every STATS_EVERY
steps. On the CPU the engine runs the same step body per batch. A batch
whose keys, shapes or dtypes differ from the epoch's first (a ragged
tail) runs the per-step path, as the JAX engine runs a stack that will
not stack. On a card Adam is torch's fused one, capturable, its learning
rate a device tensor that `set_lr` fills. With `dp` every step takes the
per-step path.

Data parallelism (`dp`, a parallel.DataParallel; the JAX trainer's data
mesh): the trainer is one rank's replica on its device, fed its rows of
each global batch. Its BNs and quantizers reduce over the ranks, its
loss normalisers are the global batch's (parallel/mesh.py), and each
step sums the gradients over the ranks before Adam, so every rank keeps
bit-equal state; the step's stats are the all-reduced sums. With
--device_cache_shard the rank's card holds only its rows of the image
cache, and `check_shard_routing` checks that each batch asks for no
other rows. Val steps run on one rank alone (the CLI runs them on rank
0), with this process's batch and no collective.

--spatial_shard k (ShuffleNetV2, the JAX trainer's get_mesh_2d): `dp`
becomes a data x spatial grid (parallel/mesh.py::grid; one process
raises, as the JAX mesh does on one device). The ranks of one data row
load the same rows of each global batch; each makes its band of the
images' rows (data/device_aug.py::model_input) and runs the backbone on
it, then the whole neck and heads on the gathered map
(models/shufflenetv2.py). The loss normalisers count the data group's
images, each rank scales its loss by 1/k before the backward (the k
ranks of a row compute the same loss), and the gradients are summed over
the world, so every rank keeps bit-equal state and a step is the
one-process step. Where an image's rows do not split over k, the batch
runs whole on every rank of its row, with the JAX mesh's warning.
"""

from __future__ import annotations

import os
import time
import warnings

import numpy as np
import torch

from .. import resolve_device
from ..data.device_aug import (IMAGE_FIELDS, image_height, model_input,
                               resolve_targets)
from ..models import create_model
from ..models.fused_heads import (apply_fused_heads,
                                  apply_fused_heads_train, can_fuse_heads)
from ..models.layers import set_data_parallel
from ..models.losses import LOSS_FACTORY
from ..ops.deform_cuda import CountedGraph
from ..parallel.mesh import (all_reduce_grads, all_sum, band,
                             broadcast_module, grid)
from ..utils.meters import AverageMeter
from .detector import device_from_opt

_ORACLES = ("eval_oracle_hm", "eval_oracle_wh", "eval_oracle_offset",
            "eval_oracle_dep", "eval_oracle_hmhp", "eval_oracle_kps",
            "eval_oracle_hp_offset")


class LossOpts:
    """The subset of opt the loss reads."""

    FIELDS = ("mse_loss", "dense_wh", "cat_spec_wh", "norm_wh", "reg_loss",
              "reg_offset", "reg_bbox", "hm_weight", "wh_weight",
              "off_weight", "hp_weight", "hm_hp_weight", "hm_hp",
              "reg_hp_offset", "dense_hp", "dep_weight", "dim_weight",
              "rot_weight")

    def __init__(self, opt, dp=None):
        for f in self.FIELDS:
            setattr(self, f, getattr(opt, f, None))
        self.dp = dp  # the normalisers' ranks (models/losses.py)


def check_shard_routing(img_idx, d, rps, first=0):
    """The --device_cache_shard contract (the JAX trainer's check): the
    rows of slot-block s of the batch (d equal blocks) lie in cache shard
    first + s, rows [(first + s) * rps, (first + s + 1) * rps). A rank
    checks its own block (d=1, first=rank) before the row lookup, which
    would otherwise read another image silently."""
    idx = np.asarray(img_idx).reshape(d, -1)
    if not (idx // rps == first + np.arange(d)[:, None]).all():
        raise ValueError(
            "--device_cache_shard: batch slot-block routing violates "
            "cache shard ownership; build the DataLoader with "
            "shard_ranges=cache.shard_ranges")


def batch_to_device(batch, device):
    """numpy batch -> tensors on `device` ('meta' dropped)."""
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
            for k, v in batch.items() if k != "meta"}


def batch_size_of(batch):
    key = ("img_idx" if "img_idx" in batch else
           "input_u8" if "input_u8" in batch else "input")
    return batch[key].shape[0]


def stacks(out):
    """The model's head dicts as a list, one per stack: hourglass returns
    its two stacks' dicts, the other networks one dict."""
    return list(out) if isinstance(out, (list, tuple)) else [out]


def make_train_step(model, loss_fn, loss_opts, optimizer, quantized, mean,
                    std, down_ratio=4, num_classes=None, input_hw=None,
                    dp=None, fuse=True):
    """step(batch on the device) -> stats {name: 0-dim tensor}, after one
    optimizer update. An image cache batch (img_idx) carries the device
    stack as 'cache_images' and is warped to `input_hw`. With `dp` the
    gradients are summed over the ranks before the update, and the stats
    are the sums of the ranks' (each rank's loss is its share of the
    global one). With `fuse` an FP32 or bf16 ShuffleNetV2 runs its heads
    fused (`apply_fused_heads_train`), the JAX train step's default. The
    step copies nothing from the host to the device: a CUDA graph can
    capture it. On a data x spatial grid (`dp.spatial` k > 1) the model
    runs on this rank's band of rows, the loss is scaled by 1/k for the
    backward and the summed stats are divided by k (the module
    docstring)."""
    fuse = fuse and not quantized and can_fuse_heads(model)
    spatial = dp.spatial if dp is not None else 1

    def stat(v, like):
        # a loss part that stays the Python 0.0 it starts as is filled on
        # the device, not copied there
        if torch.is_tensor(v):
            return v.detach().to(like.dtype)
        return torch.full((), float(v), dtype=like.dtype,
                          device=like.device)

    def spatial_band(batch):
        """(model kwargs, band, height) of a batch on the grid."""
        if spatial == 1:
            return {}, None, None
        height = image_height(batch, input_hw)
        kw = {"grid": dp, "full_height": height}
        if height % spatial:
            key = next(k for k in IMAGE_FIELDS if k in batch)
            warnings.warn(
                "spatial_shard: image H={} is not divisible by the spatial "
                "axis ({}); '{}' is replicated over 'spatial' for this "
                "batch".format(height, spatial, key), stacklevel=3)
            return kw, None, height
        sp = dp.over_spatial
        return kw, (band(height, sp), sp), height

    def step(batch):
        model.train(not quantized)
        kw, rows, height = spatial_band(batch)
        inp = model_input(batch, mean, std, input_hw,
                          batch.get("cache_images"), rows)
        batch = resolve_targets(batch, inp, down_ratio, num_classes, height)
        if quantized:
            out = model(inp, update_stats=True, **kw)
        elif fuse:
            out = apply_fused_heads_train(model, model(
                inp, return_neck=True, **kw))
        else:
            out = model(inp, **kw)
        loss, stats = loss_fn(stacks(out), batch, loss_opts)
        optimizer.zero_grad(set_to_none=True)
        # the k ranks of a data row compute the same loss: count it once
        (loss / spatial if spatial > 1 else loss).backward()
        all_reduce_grads(model.parameters(), dp)
        optimizer.step()
        stats = {k: stat(v, loss) for k, v in stats.items()}
        if dp is not None:
            summed = all_sum(torch.stack(list(stats.values())), dp)
            if spatial > 1:
                summed = summed / spatial
            stats = dict(zip(stats, summed))
        return stats

    return step


def make_oracle_val_step(model, loss_fn, loss_opts, opt, mean, std):
    """The val step with ground-truth head substitution: the
    --eval_oracle_* upper-bound probes (the JAX package's
    make_oracle_val_step; reference trains/ctdet.py:36-47,
    multi_pose.py:36-54). Each probe replaces its head (logits of the
    clipped ground-truth heatmap for hm and hm_hp; utils/oracle.py's
    nearest-object fill for wh, reg, dep, hps and hp_offset) before the
    loss."""
    from ..utils.oracle import gen_oracle_map

    def host(t):
        return t.detach().cpu().numpy()

    @torch.no_grad()
    def step(batch):
        model.eval()
        inp = model_input(batch, mean, std, (opt.input_h, opt.input_w),
                          batch.get("cache_images"))
        batch = resolve_targets(batch, inp, opt.down_ratio, opt.num_classes)
        dev = inp.device

        def put(a):
            return torch.as_tensor(np.asarray(a, np.float32), device=dev)

        def logits(gt):
            gt = np.clip(host(gt), 1e-4, 1 - 1e-4)
            return put(np.log(gt / (1 - gt)))
        subbed = []
        for output in stacks(model(inp)):
            output = dict(output)
            h, w = output[next(iter(output))].shape[1:3]
            ind = host(batch["ind"]) if "ind" in batch else None
            if opt.eval_oracle_hm and "hm" in output:
                output["hm"] = logits(batch["hm"])
            for flag, head in (("eval_oracle_wh", "wh"),
                               ("eval_oracle_offset", "reg"),
                               ("eval_oracle_dep", "dep")):
                if getattr(opt, flag) and head in output:
                    output[head] = put(gen_oracle_map(host(batch[head]),
                                                      ind, w, h))
            if opt.eval_oracle_hmhp and "hm_hp" in output:
                output["hm_hp"] = logits(batch["hm_hp"])
            if opt.eval_oracle_kps and "hps" in output:
                output["hps"] = batch["dense_hps"] if opt.dense_hp else \
                    put(gen_oracle_map(host(batch["hps"]), ind, w, h))
            if opt.eval_oracle_hp_offset and "hp_offset" in output:
                output["hp_offset"] = put(gen_oracle_map(
                    host(batch["hp_offset"]), host(batch["hp_ind"]), w, h))
            subbed.append(output)
        _, stats = loss_fn(subbed, batch, loss_opts)
        return {k: torch.as_tensor(v) for k, v in stats.items()}

    return step


def make_val_step(model, loss_fn, loss_opts, mean, std, down_ratio=4,
                  num_classes=None, input_hw=None):
    """The val step: the loss parts of an eval-mode forward. A model whose
    heads fuse runs them fused (`apply_fused_heads`); a multi-stack model
    keeps its full forward, so the val losses cover every stack (the JAX
    make_val_step)."""
    fuse = can_fuse_heads(model)

    @torch.no_grad()
    def step(batch):
        model.eval()
        inp = model_input(batch, mean, std, input_hw,
                          batch.get("cache_images"))
        batch = resolve_targets(batch, inp, down_ratio, num_classes)
        if fuse:
            out = apply_fused_heads(model, model(inp, return_neck=True))
        else:
            out = model(inp)
        _, stats = loss_fn(stacks(out), batch, loss_opts)
        return {k: torch.as_tensor(v) for k, v in stats.items()}

    return step


# train steps run eagerly on a side stream before a graph captures one
# (torch's capture recipe); each is a real step of the epoch, on its batch
GRAPH_WARMUP = 2
# an epoch's stats stay on the device and are read every this many steps
STATS_EVERY = 64


def batch_signature(batch, cache=None):
    """What a graph of a step fixes: the batch's keys, shapes and dtypes,
    and the image cache it reads (its address), if any."""
    uses_cache = "img_idx" in batch and cache is not None
    return (tuple(sorted((k, tuple(np.shape(v)), np.asarray(v).dtype.str)
                         for k, v in batch.items() if k != "meta")),
            cache.data_ptr() if uses_cache else None)


def make_multi_train_step(step_body, example, device, cache_images=None,
                          warmup=GRAPH_WARMUP):
    """The train step `step_body` replayed as one CUDA graph (the JAX
    make_multi_train_step: one program of the step for a chunk of
    batches, here one graph of the step for every batch of its
    signature).

    Returns run(batch) -> (keys, stats): each numpy batch of `example`'s
    signature is copied into static device buffers (through pinned host
    memory, non_blocking) and takes one train step; stats is the (K,)
    tensor of the step's stats on the device, in the order of `keys`.
    The first `warmup` calls run the step eagerly on a side stream (real
    steps, which create Adam's state and settle the kernels' plans), the
    next captures the step and replays it for its own batch, and every
    later call replays it. A capture or replay error raises. The graph's
    deform launches count on every replay (ops/deform_cuda.py
    CountedGraph)."""
    static = batch_to_device(example, device)
    inputs = dict(static)
    if "img_idx" in static:
        inputs["cache_images"] = cache_images
    graph = CountedGraph()
    side = torch.cuda.Stream(device)
    state = {"warmup": warmup, "out": None, "keys": None}

    def load(batch):
        for k, buf in static.items():
            src = torch.from_numpy(np.ascontiguousarray(batch[k]))
            buf.copy_(src.pin_memory(), non_blocking=True)

    def stacked(stats):
        state["keys"] = list(stats)
        return torch.stack(list(stats.values()))

    def run(batch):
        load(batch)
        if state["warmup"] > 0:
            state["warmup"] -= 1
            current = torch.cuda.current_stream(device)
            side.wait_stream(current)
            with torch.cuda.stream(side):
                out = stacked(step_body(inputs))
            current.wait_stream(side)
            out.record_stream(current)
            return state["keys"], out
        if state["out"] is None:
            with graph.capture():
                state["out"] = stacked(step_body(inputs))
        graph.replay()
        return state["keys"], state["out"].clone()

    run.graph = graph
    return run


class Trainer:
    """Epoch-loop engine (reference base_trainer.py:23-119) on one device:
    `cuda` unless opt.gpus is -1 or `device` says otherwise; with `dp`,
    one rank's replica on dp.device; with --spatial_shard, dp's ranks as
    a data x spatial grid (`grid`). `fuse_heads` False runs the train
    step's heads one by one (make_train_step's `fuse`)."""

    def __init__(self, opt, qspec=None, device=None, dp=None,
                 fuse_heads=True):
        spatial = getattr(opt, "spatial_shard", 1)
        if spatial > 1:
            if opt.arch != "shufflenetv2":
                raise NotImplementedError(
                    "--spatial_shard with --arch {} is queued in "
                    "ROADMAP.md (item 30)".format(opt.arch))
            dp = grid(dp, spatial)
        self.opt = opt
        self.qspec = qspec
        self.dp = dp
        self.fuse_heads = fuse_heads
        self.device = resolve_device(
            dp.device if dp is not None else
            device or device_from_opt(opt))
        self.model = create_model(
            opt.arch, opt.heads, opt.head_conv, w2=opt.w2,
            maxpool=opt.maxpool, qspec=qspec, dtype=opt.dtype,
            device=self.device,
            generator=torch.Generator().manual_seed(opt.seed))
        set_data_parallel(self.model, dp)
        self.loss_fn = LOSS_FACTORY[opt.task]
        self.loss_opts = LossOpts(opt)
        self.train_loss_opts = LossOpts(
            opt, dp.over_data if dp is not None else None)
        self.mean = np.asarray(opt.mean, np.float32)
        self.std = np.asarray(opt.std, np.float32)
        self.lr = opt.lr
        self.optimizer = None
        self.train_step = None
        self.input_hw = (opt.input_h, opt.input_w)
        # the device-resident image stack (data/device_cache.py), set by
        # the CLI with --device_cache; run_epoch hands it to cache batches.
        # With --device_cache_shard it holds this rank's rows alone,
        # cache_shard_rows of them from row rank * cache_shard_rows
        self.image_cache = None
        self.cache_shard_rows = None
        if any(getattr(opt, f, False) for f in _ORACLES):
            self.val_step = make_oracle_val_step(
                self.model, self.loss_fn, self.loss_opts, opt, self.mean,
                self.std)
        else:
            self.val_step = make_val_step(
                self.model, self.loss_fn, self.loss_opts, self.mean,
                self.std, opt.down_ratio, opt.num_classes, self.input_hw)
        self._hooks = None
        # the graphed train steps of the epoch engine, one per
        # batch signature (the JAX trainer's _multi_steps)
        self._multi_steps = {}

    @property
    def hooks(self):
        """The debug / save_result hooks (engine/train_hooks.py), made when
        --debug or --test first needs them."""
        if self._hooks is None:
            from .train_hooks import TrainHooks
            self._hooks = TrainHooks(self.opt, self.model)
        return self._hooks

    # -- state ---------------------------------------------------------
    def init(self):
        """Fresh Adam state over the model's parameters, at the base LR;
        with `dp`, rank 0's weights and buffers on every rank."""
        broadcast_module(self.model, self.dp)
        self.lr = self.opt.lr
        if self.device.type == "cuda":
            # capturable: its step counts and bias correction live on the
            # card, and a graphed step reads the learning rate from there;
            # fused: a few launches for all the parameters, where the
            # capturable foreach form takes a dozen foreach ops a step
            self.optimizer = torch.optim.Adam(
                self.model.parameters(), capturable=True, fused=True,
                lr=torch.tensor(self.opt.lr, dtype=torch.float32,
                                device=self.device))
        else:
            self.optimizer = torch.optim.Adam(self.model.parameters(),
                                              lr=self.opt.lr)
        self._multi_steps = {}
        self.train_step = make_train_step(
            self.model, self.loss_fn, self.train_loss_opts, self.optimizer,
            self.qspec is not None, self.mean, self.std,
            self.opt.down_ratio, self.opt.num_classes, self.input_hw,
            self.dp, self.fuse_heads)
        return self.model

    def set_lr(self, lr):
        """Step-decay hook (reference main.py:91-97)."""
        self.lr = lr
        for group in self.optimizer.param_groups:
            if torch.is_tensor(group["lr"]):
                group["lr"].fill_(lr)  # the graphs read it in place
            else:
                group["lr"] = lr

    # -- epochs ----------------------------------------------------------
    def _run_epoch_scan(self, loader, n_iters, meters):
        """The graphed epoch engine (the JAX trainer's _run_epoch_scan):
        each batch takes its step as the loader delivers it, on a card as
        a replay of the graph of its signature (`make_multi_train_step`),
        on the CPU through the step body; the stats stay on the device
        and are read every STATS_EVERY steps. A batch whose signature
        differs from the epoch's first runs the per-step path."""
        graphs = self.device.type == "cuda"
        rows = self.cache_shard_rows
        pending = []  # (keys, stats (K,) on the device, batch size)
        first = None

        def flush():
            if not pending:
                return
            values = torch.cat([st for _, st, _ in pending]).cpu().numpy()
            i = 0
            for keys, _, bs in pending:
                for k in keys:
                    meters.setdefault(k, AverageMeter()).update(
                        float(values[i]), bs)
                    i += 1
            pending.clear()

        def per_step(batch):
            batch = batch_to_device(batch, self.device)
            if "img_idx" in batch:
                batch["cache_images"] = self.image_cache
            stats = self.train_step(batch)
            return list(stats), torch.stack(list(stats.values()))

        for it, batch in enumerate(loader):
            if it >= n_iters:
                break
            batch = {k: v for k, v in batch.items() if k != "meta"}
            if rows and "img_idx" in batch:
                check_shard_routing(batch["img_idx"], 1, rows)
            sig = batch_signature(batch, self.image_cache)
            first = sig if first is None else first
            if graphs and sig == first:
                run = self._multi_steps.get(sig)
                if run is None:
                    run = self._multi_steps[sig] = make_multi_train_step(
                        self.train_step, batch, self.device,
                        self.image_cache)
                keys, stats = run(batch)
            else:
                keys, stats = per_step(batch)
            pending.append((keys, stats, batch_size_of(batch)))
            if len(pending) >= STATS_EVERY:
                flush()
        flush()
        return {k: m.avg for k, m in meters.items()}

    def run_epoch(self, phase, epoch, loader, num_iters=-1, print_iter=0,
                  results=None):
        """One epoch of `phase` steps; the meters' averages. With --debug
        each batch's first image is rendered after its step, and with
        --test and a `results` dict its decoded predictions go there.
        Where none of these watches the steps, a train epoch runs the
        graphed engine (`_run_epoch_scan`) under the JAX trainer's
        conditions."""
        meters = {}
        data_time = AverageMeter()
        batch_time = AverageMeter()
        n_iters = len(loader) if num_iters < 0 else num_iters
        if (phase == "train" and self.dp is None
                and not self.opt.debug > 0
                and not (results is not None and self.opt.test)
                and print_iter <= 0
                and os.environ.get("CODENET_SCAN_EPOCH", "1") == "1"):
            return self._run_epoch_scan(loader, n_iters, meters)
        # stats stay on the device until printed or the epoch ends: a
        # float() per step would sync the host with the card every step
        pending = []

        def flush():
            for stats, bs in pending:
                for k, v in stats.items():
                    meters.setdefault(k, AverageMeter()).update(float(v),
                                                                bs)
            pending.clear()

        step = self.train_step if phase == "train" else self.val_step
        # a train step's stats are the global batch's; a rank's rows of
        # each batch and its cache shard follow its data row
        ranks = self.dp.data_world if self.dp is not None \
            and phase == "train" else 1
        rank = self.dp.data_rank if self.dp is not None else 0
        show = self.dp is None or self.dp.main
        end = time.time()
        for it, batch in enumerate(loader):
            if it >= n_iters:
                break
            bs = batch_size_of(batch) * ranks
            meta = batch.get("meta")
            rows = self.cache_shard_rows
            if rows and "img_idx" in batch:
                # this rank's cache holds rows [rank * rows, ...) alone
                check_shard_routing(batch["img_idx"], 1, rows, first=rank)
                batch = dict(batch, img_idx=batch["img_idx"] - rank * rows)
            batch = batch_to_device(batch, self.device)
            if "img_idx" in batch:
                batch["cache_images"] = self.image_cache
            data_time.update(time.time() - end)
            pending.append((step(batch), bs))
            if len(pending) >= STATS_EVERY:
                flush()
            batch_time.update(time.time() - end)
            end = time.time()
            if print_iter and it % print_iter == 0 and show:
                flush()
                msg = " ".join("{} {:.4f}".format(k, m.avg)
                               for k, m in meters.items())
                times = "" if getattr(self.opt, "hide_data_time", False) \
                    else " | data {:.3f}s net {:.3f}s".format(
                        data_time.avg, batch_time.avg)
                print("{} epoch {} [{}/{}] {}{}".format(
                    phase, epoch, it, n_iters, msg, times))
            want_debug = self.opt.debug > 0
            want_save = results is not None and self.opt.test
            if want_debug or want_save:
                fwd_out = self.hooks.forward(batch)
                if want_debug:
                    self.hooks.debug(batch, meta, it, phase=phase,
                                     fwd_out=fwd_out)
                if want_save:
                    self.hooks.save_result(batch, meta, results,
                                           fwd_out=fwd_out)
        flush()
        return {k: m.avg for k, m in meters.items()}

    def train(self, epoch, loader):
        return self.run_epoch("train", epoch, loader,
                              num_iters=self.opt.num_iters,
                              print_iter=self.opt.print_iter)

    def val(self, epoch, loader):
        """Returns (stats, results), as the reference trainer.val: with
        --test, `results` holds each val image's decoded detections
        (ctdet, multi_pose, ddd), keyed by image id; else it stays
        empty."""
        results = {}
        stats = self.run_epoch("val", epoch, loader, results=results)
        return stats, results
