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

The epoch loop is the JAX package's per-step path, with its hooks:
--debug renders and --test's decoded val results (engine/train_hooks.py)
and the --eval_oracle_* probes (make_oracle_val_step). Its scan-epoch
engine and fused train heads are not ported; --spatial_shard raises.

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
"""

from __future__ import annotations

import time

import numpy as np
import torch

from .. import resolve_device
from ..data.device_aug import model_input, resolve_targets
from ..models import create_model
from ..models.layers import set_data_parallel
from ..models.losses import LOSS_FACTORY
from ..parallel.mesh import all_reduce_grads, all_sum, broadcast_module
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
                    dp=None):
    """step(batch on the device) -> stats {name: 0-dim tensor}, after one
    optimizer update. An image cache batch (img_idx) carries the device
    stack as 'cache_images' and is warped to `input_hw`. With `dp` the
    gradients are summed over the ranks before the update, and the stats
    are the sums of the ranks' (each rank's loss is its share of the
    global one)."""

    def step(batch):
        model.train(not quantized)
        inp = model_input(batch, mean, std, input_hw,
                          batch.get("cache_images"))
        batch = resolve_targets(batch, inp, down_ratio, num_classes)
        if quantized:
            out = model(inp, update_stats=True)
        else:
            out = model(inp)
        loss, stats = loss_fn(stacks(out), batch, loss_opts)
        optimizer.zero_grad(set_to_none=True)
        loss.backward()
        all_reduce_grads(model.parameters(), dp)
        optimizer.step()
        stats = {k: torch.as_tensor(v, dtype=loss.dtype,
                                    device=loss.device).detach()
                 for k, v in stats.items()}
        if dp is not None:
            summed = all_sum(torch.stack(list(stats.values())), dp)
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
    @torch.no_grad()
    def step(batch):
        model.eval()
        inp = model_input(batch, mean, std, input_hw,
                          batch.get("cache_images"))
        batch = resolve_targets(batch, inp, down_ratio, num_classes)
        _, stats = loss_fn(stacks(model(inp)), batch, loss_opts)
        return {k: torch.as_tensor(v) for k, v in stats.items()}

    return step


class Trainer:
    """Epoch-loop engine (reference base_trainer.py:23-119) on one device:
    `cuda` unless opt.gpus is -1 or `device` says otherwise; with `dp`,
    one rank's replica on dp.device."""

    def __init__(self, opt, qspec=None, device=None, dp=None):
        if getattr(opt, "spatial_shard", 1) > 1:
            raise NotImplementedError(
                "--spatial_shard (halo-exchanged convs) is queued in "
                "ROADMAP.md (item 20)")
        self.opt = opt
        self.qspec = qspec
        self.dp = dp
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
        self.train_loss_opts = LossOpts(opt, dp)
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
        self.optimizer = torch.optim.Adam(self.model.parameters(),
                                          lr=self.opt.lr)
        self.train_step = make_train_step(
            self.model, self.loss_fn, self.train_loss_opts, self.optimizer,
            self.qspec is not None, self.mean, self.std,
            self.opt.down_ratio, self.opt.num_classes, self.input_hw,
            self.dp)
        return self.model

    def set_lr(self, lr):
        """Step-decay hook (reference main.py:91-97)."""
        self.lr = lr
        for group in self.optimizer.param_groups:
            group["lr"] = lr

    # -- epochs ----------------------------------------------------------
    def run_epoch(self, phase, epoch, loader, num_iters=-1, print_iter=0,
                  results=None):
        """One epoch of `phase` steps; the meters' averages. With --debug
        each batch's first image is rendered after its step, and with
        --test and a `results` dict its decoded predictions go there."""
        meters = {}
        data_time = AverageMeter()
        batch_time = AverageMeter()
        n_iters = len(loader) if num_iters < 0 else num_iters
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
        # a train step's stats are the global batch's
        ranks = self.dp.world if self.dp is not None and phase == "train" \
            else 1
        rank = self.dp.rank if self.dp is not None else 0
        show = rank == 0
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
            if len(pending) > 64:
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
