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
``--test`` only decodes and scores the val split; ``--debug N`` renders
each batch's first image into exp/<task>/<exp_id>/debug/;
``--eval_oracle_*`` replaces heads by their ground truth in the val loss.
``--device_cache`` (ctdet) holds the train split's raw frames on the
device and warps them there; ``--host_normalize`` augments and normalises
on the host (the reference's path). Checkpoints are .pth files in
exp/<task>/<exp_id>/.
"""

from __future__ import annotations

import os

from .. import config as cfg
from ..data.datasets import get_dataset
from ..data.loader import DataLoader
from ..data.samplers import check_sampler_opt
from ..engine import checkpoint
from ..engine.trainer import Trainer
from ..utils.logger import Logger


def run_training(opt, qspec=None):
    if opt.trace:
        raise NotImplementedError(
            "--trace is queued in ROADMAP.md (item 23)")
    check_sampler_opt(opt)
    Dataset = get_dataset(opt.dataset, opt.task)
    opt = cfg.update_dataset_info_and_set_heads(
        opt, cfg.DATASET_SPECS[opt.dataset])
    print(opt.heads)

    trainer = Trainer(opt, qspec=qspec)
    logger = Logger(opt, trainer.device)
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
        _, preds = trainer.val(0, val_loader)
        os.makedirs(opt.save_dir, exist_ok=True)
        val_loader.dataset.run_eval(preds, opt.save_dir)
        logger.close()
        return trainer
    train_dataset = Dataset(opt, "train")
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
        trainer.image_cache = cache.to_device(trainer.device)
        print("device_cache: {} images, {:.1f} MB -> {}".format(
            len(train_dataset), cache.nbytes / 1e6, trainer.device))
    train_loader = DataLoader(train_dataset, opt.batch_size,
                              shuffle=True, num_workers=opt.num_workers,
                              seed=opt.seed)

    def save(name, epoch, with_optimizer=True):
        checkpoint.save_model(
            os.path.join(opt.save_dir, name), epoch, trainer.model,
            trainer.optimizer if with_optimizer else None, qspec)

    best = 1e10
    os.makedirs(opt.save_dir, exist_ok=True)
    for epoch in range(start_epoch + 1, opt.num_epochs + 1):
        # --save_all keeps every epoch as model_<epoch> (reference main.py:69)
        mark = str(epoch) if opt.save_all else "last"
        log_dict = trainer.train(epoch, train_loader)
        logger.write("epoch: {} |".format(epoch))
        for k, v in log_dict.items():
            logger.scalar_summary("train_{}".format(k), v, epoch)
            logger.write("{} {:8f} | ".format(k, v))
        if opt.val_intervals > 0 and epoch % opt.val_intervals == 0:
            save("model_{}.pth".format(mark), epoch)
            val_dict, _ = trainer.val(epoch, val_loader)
            for k, v in val_dict.items():
                logger.scalar_summary("val_{}".format(k), v, epoch)
                logger.write("{} {:8f} | ".format(k, v))
            # model_best only on improvement (reference main.py:83-86)
            if val_dict[opt.metric] < best:
                best = val_dict[opt.metric]
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
    if opt.task == "ctdet" and opt.num_epochs > 0:
        from .test import prefetch_test
        last = "model_{}.pth".format(opt.num_epochs) if opt.save_all \
            else "model_last.pth"
        opt.load_model = os.path.join(opt.save_dir, last)
        opt.resume_quantize = qspec is not None
        print("Running final eval...")
        prefetch_test(opt)
    logger.close()
    return trainer


def main(argv=None):
    return run_training(cfg.parse(argv))


if __name__ == "__main__":
    main()
