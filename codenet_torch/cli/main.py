"""FP32 training CLI (the JAX package's cli/main.py; reference main.py:
19-102).

dataset -> heads -> model -> Adam -> epoch loop with val, checkpoints and
step-LR decay (x0.1 at each lr_step epoch), then, for ctdet, a detection
eval of the last checkpoint (reference quant_main.py:104-107).

    python -m codenet_torch.cli.main ctdet --dataset pascal \\
        --arch shufflenetv2 --input_res 256 --batch_size 32 [--gpus -1]
    python -m codenet_torch.cli.main multi_pose --dataset coco_hp \\
        --arch shufflenetv2 --batch_size 32 [--gpus -1]
    python -m codenet_torch.cli.main ddd --dataset kitti \\
        --arch shufflenetv2 --batch_size 16 [--gpus -1]
    python -m codenet_torch.cli.main exdet --dataset coco \\
        --arch shufflenetv2 --batch_size 32 [--gpus -1]

``--gpus -1`` runs on the CPU; otherwise the CUDA card is required.
``--gpus 0,1,...`` trains data-parallel, one spawned process per listed
card (NCCL), on the largest count of them that divides --batch_size;
under torchrun (RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR in the
environment) this process joins that group as its rank instead, on card
LOCAL_RANK, or on the CPU over gloo with ``--gpus -1``:

    torchrun --nproc_per_node 4 -m codenet_torch.cli.main ctdet ...
    torchrun --nnodes 2 --node_rank R --nproc_per_node 8 \\
        --master_addr HOST --master_port PORT -m codenet_torch.cli.main ...

Each rank trains on its rows of every global batch with global-batch BN
(parallel/mesh.py); rank 0 logs, writes the checkpoints and runs the val
passes and the final eval, whose detections are those of a one-process
run from the same weights. ``--spatial_shard k`` makes the ranks a data
x spatial grid (the JAX package's get_mesh_2d): k must divide the ranks
(one process raises), the data axis shrinks until it divides
--batch_size, and the k ranks of a data row train on the same rows, each
on its band of the images' rows (engine/trainer.py).
``--trace`` writes a profiler trace of the epochs into
exp/<task>/<exp_id>/debug/trace/ (one file per rank; utils/profile.py);
``--test`` only decodes and scores the val split; ``--debug N`` renders
each batch's first image into exp/<task>/<exp_id>/debug/;
``--eval_oracle_*`` replaces heads by their ground truth in the val loss.
``--device_cache`` (ctdet) holds the train split's raw frames on the
device and warps them there (``--device_cache_shard``: each rank's card
holds its share of the rows, and each rank's rows of every batch come
from its share); ``--host_normalize`` augments and normalises on the
host (the reference's path). Checkpoints are .pth files in
exp/<task>/<exp_id>/.
"""

from __future__ import annotations

import contextlib
import os
import sys

import torch

from .. import config as cfg
from ..data.datasets import get_dataset
from ..data.loader import DataLoader
from ..engine import checkpoint
from ..engine.trainer import Trainer
from ..parallel import (all_max, join_from_env, launch,
                        launched_by_torchrun, leave, process_batch_slice,
                        world_for_batch)
from ..parallel.mesh import grid_for_batch
from ..utils.logger import Logger
from ..utils.profile import maybe_trace


def run_training(opt, qspec=None, dp=None):
    """Train (FP32, or QAT with `qspec`) in this process: alone, or as
    rank dp.rank of a data-parallel group."""
    Dataset = get_dataset(opt.dataset, opt.task)
    opt = cfg.update_dataset_info_and_set_heads(
        opt, cfg.DATASET_SPECS[opt.dataset])
    print(opt.heads)
    main_rank = dp is None or dp.main

    trainer = Trainer(opt, qspec=qspec, dp=dp)
    dp = trainer.dp  # with --spatial_shard, the data x spatial grid
    logger = Logger(opt, trainer.device, rank=dp.rank if dp else 0)
    trainer.init()

    start_epoch = 0
    if opt.load_model:
        _, ckpt_epoch = checkpoint.load_model(opt.load_model, trainer.model)
        if opt.resume:
            # as in the JAX package: weights and epoch resume, Adam's
            # moments start afresh
            start_epoch = ckpt_epoch
            lr = checkpoint.resume_lr(opt.lr, opt.lr_step, start_epoch)
            trainer.set_lr(lr)
            print("Resumed optimizer with start lr", lr)

    val_loader = DataLoader(Dataset(opt, "val"), 1, shuffle=False,
                            num_workers=1)
    if opt.test:
        # val only: decode the val images' predictions and score them
        # (reference main.py:51-54)
        if main_rank:
            _, preds = trainer.val(0, val_loader)
            os.makedirs(opt.save_dir, exist_ok=True)
            val_loader.dataset.run_eval(preds, opt.save_dir)
        logger.close()
        return trainer
    train_dataset = Dataset(opt, "train")
    shard_ranges = None
    if opt.device_cache:
        if opt.task != "ctdet":
            raise SystemExit(
                "--device_cache is only implemented for the ctdet task "
                "(the {} sampler has no cached-feed path); drop the flag"
                .format(opt.task))
        # the raw frames on the card, copied once; steps then ship only
        # row indices, warp matrices and targets (data/device_cache.py)
        from ..data.device_cache import ImageCache
        cache = ImageCache.build(train_dataset)
        train_dataset._image_cache_dims = cache.dims
        shard = opt.device_cache_shard
        # the cache's rows are split over the data axis; the ranks of a
        # data row hold the same shard
        trainer.image_cache = cache.to_device(
            trainer.device, shard=shard,
            dp=dp.over_data if dp is not None else None)
        if shard:
            shard_ranges = cache.shard_ranges
            trainer.cache_shard_rows = cache.shard_rows
        print("device_cache: {} images, {:.1f} MB -> {}{}".format(
            len(train_dataset), cache.nbytes / 1e6, trainer.device,
            " (sharded over {} ranks)".format(len(shard_ranges))
            if shard else ""))
    train_loader = DataLoader(
        train_dataset, opt.batch_size, shuffle=True,
        num_workers=opt.num_workers, seed=opt.seed,
        shard_ranges=shard_ranges,
        rows=process_batch_slice(opt.batch_size, dp.data_rank,
                                 dp.data_world)
        if dp is not None else None)

    def save(name, epoch, with_optimizer=True):
        checkpoint.save_model(
            os.path.join(opt.save_dir, name), epoch, trainer.model,
            trainer.optimizer if with_optimizer else None, qspec, dp=dp)

    best = 1e10
    os.makedirs(opt.save_dir, exist_ok=True)
    # --trace: a profiler trace of the epochs, one file per rank
    with maybe_trace(opt, trainer.device, dp.rank if dp else None):
        for epoch in range(start_epoch + 1, opt.num_epochs + 1):
            # --save_all keeps every epoch as model_<epoch> (reference
            # main.py:69)
            mark = str(epoch) if opt.save_all else "last"
            log_dict = trainer.train(epoch, train_loader)
            logger.write("epoch: {} |".format(epoch))
            for k, v in log_dict.items():
                logger.scalar_summary("train_{}".format(k), v, epoch)
                logger.write("{} {:8f} | ".format(k, v))
            if opt.val_intervals > 0 and epoch % opt.val_intervals == 0:
                save("model_{}.pth".format(mark), epoch)
                improved = False
                if main_rank:  # the val pass runs on rank 0 alone
                    val_dict, _ = trainer.val(epoch, val_loader)
                    for k, v in val_dict.items():
                        logger.scalar_summary("val_{}".format(k), v, epoch)
                        logger.write("{} {:8f} | ".format(k, v))
                    improved = val_dict[opt.metric] < best
                    if improved:
                        best = val_dict[opt.metric]
                if dp is not None:  # rank 0's verdict, on every rank
                    improved = bool(all_max(torch.tensor(
                        [float(improved)], device=trainer.device), dp)[0])
                # model_best only on improvement (reference main.py:83-86)
                if improved:
                    save("model_best.pth", epoch, with_optimizer=False)
            elif (epoch % max(1, opt.save_intervals) == 0
                  or epoch == opt.num_epochs or opt.save_all):
                save("model_{}.pth".format(mark), epoch)
            logger.write("\n")
            if epoch in opt.lr_step:
                save("model_{}.pth".format(epoch), epoch)
                lr = opt.lr * (0.1 ** (opt.lr_step.index(epoch) + 1))
                print("Drop LR to", lr)
                trainer.set_lr(lr)

    # the final eval runs for ctdet only, as in the JAX package, also
    # after a --resume at the last epoch; unlike there, an eval that
    # fails raises
    if opt.task == "ctdet" and opt.num_epochs > 0 and main_rank:
        from .test import prefetch_test
        trainer.image_cache = None  # the train cache's memory first
        last = "model_{}.pth".format(opt.num_epochs) if opt.save_all \
            else "model_last.pth"
        opt.load_model = os.path.join(opt.save_dir, last)
        opt.resume_quantize = qspec is not None
        print("Running final eval...")
        prefetch_test(opt)
    logger.close()
    return trainer


@contextlib.contextmanager
def _quiet_unless_main(dp):
    """Only rank 0 prints."""
    if dp.main:
        yield
        return
    with open(os.devnull, "w") as null, contextlib.redirect_stdout(null):
        yield


def _rank_main(dp, opt, qspec):
    with _quiet_unless_main(dp):
        run_training(opt, qspec, dp)


def train(opt, qspec=None):
    """Run training as the command line asks: as this process's rank of a
    torchrun group; on every card of --gpus (spawned ranks, NCCL) when
    it lists several; else in this process. Returns the trainer of a
    one-process run."""
    spatial = opt.spatial_shard
    if launched_by_torchrun():
        dp = join_from_env(opt.batch_size, cpu=opt.gpus[0] < 0,
                           spatial=spatial)
        try:
            with _quiet_unless_main(dp):
                return run_training(opt, qspec, dp)
        finally:
            leave(dp)
    ids = [int(g) for g in opt.gpus_str.split(",")][:len(opt.gpus)]
    if opt.gpus[0] < 0 or len(ids) == 1 or opt.test:
        return run_training(opt, qspec)
    if spatial > 1:
        rows, _ = grid_for_batch(opt.batch_size, len(ids), spatial)
        world = rows * spatial
        if world < len(ids):
            print("note: --batch_size {} does not divide over {} data "
                  "rows; training on {} x {} cards".format(
                      opt.batch_size, len(ids) // spatial, rows, spatial))
        sys.stdout.flush()
        launch(_rank_main, ["cuda:{}".format(i) for i in ids[:world]],
               args=(opt, qspec))
        return None
    world = world_for_batch(opt.batch_size, len(ids))
    if world < len(ids):
        print("note: --batch_size {} does not divide over {} cards; "
              "training on {}".format(opt.batch_size, len(ids), world))
    if world == 1:
        return run_training(opt, qspec)
    sys.stdout.flush()
    launch(_rank_main, ["cuda:{}".format(i) for i in ids[:world]],
           args=(opt, qspec))
    return None


def main(argv=None):
    return train(cfg.parse(argv))


if __name__ == "__main__":
    main()
