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

The epoch loop is the JAX package's per-step path. Its scan-epoch engine,
fused train heads, oracle probes and debug / result hooks are not ported
and their flags raise.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from .. import resolve_device
from ..data.device_aug import model_input, resolve_targets
from ..models import create_model
from ..models.losses import LOSS_FACTORY
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

    def __init__(self, opt):
        for f in self.FIELDS:
            setattr(self, f, getattr(opt, f, None))


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
                    std, down_ratio=4, num_classes=None, input_hw=None):
    """step(batch on the device) -> stats {name: 0-dim tensor}, after one
    optimizer update. An image cache batch (img_idx) carries the device
    stack as 'cache_images' and is warped to `input_hw`."""

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
        optimizer.step()
        return {k: torch.as_tensor(v).detach() for k, v in stats.items()}

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
    `cuda` unless opt.gpus is -1 or `device` says otherwise."""

    def __init__(self, opt, qspec=None, device=None):
        unported = [f for f in _ORACLES if getattr(opt, f, False)]
        if getattr(opt, "debug", 0) > 0:
            unported.append("--debug")
        if getattr(opt, "spatial_shard", 1) > 1:
            unported.append("--spatial_shard")
        if unported:
            raise NotImplementedError(
                "{} queued in ROADMAP.md".format(", ".join(unported)))
        self.opt = opt
        self.qspec = qspec
        self.device = resolve_device(device or device_from_opt(opt))
        self.model = create_model(
            opt.arch, opt.heads, opt.head_conv, w2=opt.w2,
            maxpool=opt.maxpool, qspec=qspec, dtype=opt.dtype,
            device=self.device,
            generator=torch.Generator().manual_seed(opt.seed))
        self.loss_fn = LOSS_FACTORY[opt.task]
        self.loss_opts = LossOpts(opt)
        self.mean = np.asarray(opt.mean, np.float32)
        self.std = np.asarray(opt.std, np.float32)
        self.lr = opt.lr
        self.optimizer = None
        self.train_step = None
        self.input_hw = (opt.input_h, opt.input_w)
        # the device-resident image stack (data/device_cache.py), set by
        # the CLI with --device_cache; run_epoch hands it to cache batches
        self.image_cache = None
        self.val_step = make_val_step(self.model, self.loss_fn,
                                      self.loss_opts, self.mean, self.std,
                                      opt.down_ratio, opt.num_classes,
                                      self.input_hw)

    # -- state ---------------------------------------------------------
    def init(self):
        """Fresh Adam state over the model's parameters, at the base LR."""
        self.lr = self.opt.lr
        self.optimizer = torch.optim.Adam(self.model.parameters(),
                                          lr=self.opt.lr)
        self.train_step = make_train_step(
            self.model, self.loss_fn, self.loss_opts, self.optimizer,
            self.qspec is not None, self.mean, self.std,
            self.opt.down_ratio, self.opt.num_classes, self.input_hw)
        return self.model

    def set_lr(self, lr):
        """Step-decay hook (reference main.py:91-97)."""
        self.lr = lr
        for group in self.optimizer.param_groups:
            group["lr"] = lr

    # -- epochs ----------------------------------------------------------
    def run_epoch(self, phase, epoch, loader, num_iters=-1, print_iter=0):
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
        end = time.time()
        for it, batch in enumerate(loader):
            if it >= n_iters:
                break
            bs = batch_size_of(batch)
            batch = batch_to_device(batch, self.device)
            if "img_idx" in batch:
                batch["cache_images"] = self.image_cache
            data_time.update(time.time() - end)
            pending.append((step(batch), bs))
            if len(pending) > 64:
                flush()
            batch_time.update(time.time() - end)
            end = time.time()
            if print_iter and it % print_iter == 0:
                flush()
                msg = " ".join("{} {:.4f}".format(k, m.avg)
                               for k, m in meters.items())
                times = "" if getattr(self.opt, "hide_data_time", False) \
                    else " | data {:.3f}s net {:.3f}s".format(
                        data_time.avg, batch_time.avg)
                print("{} epoch {} [{}/{}] {}{}".format(
                    phase, epoch, it, n_iters, msg, times))
        flush()
        return {k: m.avg for k, m in meters.items()}

    def train(self, epoch, loader):
        return self.run_epoch("train", epoch, loader,
                              num_iters=self.opt.num_iters,
                              print_iter=self.opt.print_iter)

    def val(self, epoch, loader):
        """Returns (stats, results); results stays empty (the decoded
        predictions of --test are not ported)."""
        return self.run_epoch("val", epoch, loader), {}
