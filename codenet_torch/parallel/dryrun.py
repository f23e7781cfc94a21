"""Multi-rank dryrun on the CPU (the JAX package's parallel/dryrun.py).

    python -m codenet_torch.parallel.dryrun N

spawns N gloo ranks on the CPU and runs the full train step of ctdet
ShuffleNetV2-DCN 1x at 64^2 on a global batch of 2N, the JAX dryrun's
shapes, in the data-parallel regimes the port has:

1. dp: the batch split over the ranks (global-batch BN, gradients summed
   over the ranks);
2. dp x sp (--spatial_shard 2, for an even N): the ranks as a data x
   spatial grid, each image's rows split over the 2 ranks of its data
   row (halo-exchanged backbone, the map gathered ahead of the deform
   stage); its loss must be within 5% of the dp step's, as in the JAX
   dryrun;
3. dp + sharded cache (--device_cache_shard): each rank holds its rows of
   the raw-image stack, and its rows of the batch (slot-block s for rank
   s) index only those.

Each phase checks a finite loss and bit-equal replicas, and rank 0 prints
one line a phase.
"""

from __future__ import annotations

import sys

import numpy as np
import torch


def _opt(batch, *extra):
    from .. import config as cfg
    opt = cfg.parse(["ctdet", "--dataset", "pascal", "--arch",
                     "shufflenetv2", "--input_res", "64", "--batch_size",
                     str(batch), "--num_epochs", "1", "--gpus", "-1",
                     *extra])
    return cfg.update_dataset_info_and_set_heads(
        opt, cfg.DATASET_SPECS["pascal"])


def _report(dp, trainer, name, stats):
    from .mesh import check_replicas_equal
    loss = float(stats["loss"])
    if not np.isfinite(loss):
        raise RuntimeError("{}: loss {}".format(name, loss))
    check_replicas_equal(trainer.model, trainer.dp)
    if dp.main:
        print("dryrun({}): {} loss={:.4f} OK".format(dp.world, name, loss),
              flush=True)
    return loss


def _rank(dp):
    from ..data.device_aug import identity_aug_params
    from ..data.device_cache import ImageCache
    from ..engine.trainer import Trainer
    from .multihost import process_batch_slice
    torch.set_num_threads(1)
    n, b, out_res = dp.world, 2 * dp.world, 16
    lo, hi = process_batch_slice(b, dp.rank, n)
    rng = np.random.RandomState(0)
    batch = {
        "input": rng.randn(b, 64, 64, 3).astype(np.float32),
        "hm": np.zeros((b, out_res, out_res, 20), np.float32),
        "wh": np.zeros((b, 50, 2), np.float32),
        "reg": np.zeros((b, 50, 2), np.float32),
        "ind": np.zeros((b, 50), np.int64),
        "reg_mask": np.ones((b, 50), np.uint8)}
    batch["hm"][:, 8, 8, 0] = 1.0
    batch["ind"][:, 0] = 8 * out_res + 8

    trainer = Trainer(_opt(b), dp=dp)
    trainer.init()
    stats = trainer.run_epoch(
        "train", 1, [{k: v[lo:hi] for k, v in batch.items()}])
    loss = _report(dp, trainer, "dp", stats)

    if n % 2 == 0:
        trainer = Trainer(_opt(b, "--spatial_shard", "2"), dp=dp)
        trainer.init()
        grid = trainer.dp
        lo2, hi2 = process_batch_slice(b, grid.data_rank, grid.data_world)
        stats = trainer.run_epoch(
            "train", 1, [{k: v[lo2:hi2] for k, v in batch.items()}])
        loss2 = float(stats["loss"])
        if abs(loss2 - loss) >= 0.05 * max(abs(loss), 1.0):
            raise RuntimeError("dp x sp loss {} against dp {}".format(
                loss2, loss))
        _report(dp, trainer, "dp x sp", stats)

    trainer = Trainer(_opt(b, "--device_cache_shard"), dp=dp)
    trainer.init()
    images = rng.randint(0, 255, (b, 64, 64, 3)).astype(np.uint8)
    cache = ImageCache(images, np.full((b, 2), 64, np.int32))
    trainer.image_cache = cache.to_device(dp.device, shard=True, dp=dp)
    trainer.cache_shard_rows = rps = cache.shard_rows
    perm, alphas, light = identity_aug_params()
    batch3 = {
        "img_idx": np.concatenate(  # slot-block s -> shard s's rows
            [np.arange(s * rps, s * rps + b // n)
             for s in range(n)]).astype(np.int32),
        "warp_ti": np.tile(np.array([[1, 0, 0], [0, 1, 0]], np.float32),
                           (b, 1, 1)),
        "aug_perm": np.full((b,), perm, np.int32),
        "aug_alphas": np.tile(np.asarray(alphas, np.float32), (b, 1)),
        "aug_light": np.tile(np.asarray(light, np.float32), (b, 1)),
        **{k: v for k, v in batch.items() if k != "input"}}
    stats = trainer.run_epoch(
        "train", 1, [{k: v[lo:hi] for k, v in batch3.items()}])
    _report(dp, trainer, "dp + sharded-cache", stats)


def run(n):
    from .mesh import launch
    launch(_rank, ["cpu"] * n, backend="gloo")


if __name__ == "__main__":
    run(int(sys.argv[1]) if len(sys.argv) > 1 else 8)
