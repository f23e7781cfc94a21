"""Rank bodies of the port's --spatial_shard tests
(test_torch_spatial.py), and the one-process references they are held
to. Run as

    python tests/torch_spatial_worker.py SCENARIO OUT_DIR

which spawns the scenario's gloo ranks on the CPU through
``codenet_torch.parallel.launch``; rank k writes OUT_DIR/rank<k>.pt.
Imports nothing of JAX. Every input is made with numpy from a seed and is
the same on every rank; the ranks of a data row keep that row's rows of
each global batch (process_batch_slice over the data axis).

- ``grid4``, four ranks: each halo'd conv and pool of the backbone at
  spatial 2 and 4; 2 FP32 and 2 QAT steps at dp 2 x sp 2; one step at
  dp 1 x sp 4, where layer3's two output rows do not split and the map
  is gathered ahead of it; one f32 --device_cache_shard step at dp 2 x
  sp 2 with colour aug (the contrast's grey mean) through
  Trainer.run_epoch;
- ``grid2``, two ranks: a res_18 Trainer's grid, 2 FP32 and 2 QAT
  steps at dp 1 x sp 2 (f64), 2 FP32 steps in f32 (for the JAX mesh),
  the colour aug of a band and one f32 step of a uint8 batch with colour
  aug;
- ``grid3``, three ranks: one step at dp 1 x sp 3 of 64-row images,
  which do not split (the warning, the batch run whole);
- ``engine``, two ranks (test_torch_dp_engine.py): the graphed epoch
  engine's epoch at dp 1 x sp 2 against the per-step path's.
"""

import os
import sys
import warnings

import numpy as np
import torch
import torch.nn.functional as F

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

from torch_parallel_worker import (  # noqa: E402
    GLOBAL_BATCH, RES, conditioned_state, step_batches, task_opt, tensors)
from codenet_torch.parallel import launch, process_batch_slice  # noqa: E402

STEPS = 2
WORLDS = {"grid4": 4, "grid2": 2, "grid3": 3}

# name -> (channels in, rows, kernel, stride, padding, groups, pool): the
# backbone's windows over rows at small sizes: the stride-4 stem, the
# stride-2 stem and its 3x3/2 max pool, depthwise at stride 1 and 2, 1x1
OPS = {"stem_s4": (3, 64, 3, 4, 1, 1, False),
       "stem_s2": (3, 64, 3, 2, 1, 1, False),
       "max_pool": (6, 32, 3, 2, 1, 1, True),
       "dw_s1": (6, 16, 3, 1, 1, 6, False),
       "dw_s2": (6, 16, 3, 2, 1, 6, False),
       "pw": (6, 16, 1, 1, 0, 1, False)}
OP_WIDTH = 12


def op_case(name):
    """(module, x, the output's gradient) of op `name`, f64, seeded."""
    c, h, k, stride, pad, groups, pool = OPS[name]
    r = np.random.RandomState(sum(map(ord, name)))
    x = torch.from_numpy(r.randn(2, c, h, OP_WIDTH)).contiguous(
        memory_format=torch.channels_last)
    if pool:
        mod = torch.nn.MaxPool2d(k, stride, pad)
        cout = c
    else:
        cout = 6
        mod = torch.nn.Conv2d(c, cout, k, stride, pad, groups=groups,
                              bias=False).double()
        with torch.no_grad():
            mod.weight.copy_(torch.from_numpy(r.randn(*mod.weight.shape)))
    ho = (h + 2 * pad - k) // stride + 1
    wo = (OP_WIDTH + 2 * pad - k) // stride + 1
    return mod, x, torch.from_numpy(r.randn(2, cout, ho, wo))


def op_reference(name):
    """The unsharded op: output and dx."""
    mod, x, g = op_case(name)
    x = x.clone().requires_grad_()
    y = mod(x)
    y.backward(g)
    return y.detach(), x.grad


def op_results(dp, spatial):
    """Each op on this rank's band through the model's layers (conv_q and
    pool_rows inside row_sharded): the gathered output and the band's
    dx."""
    from codenet_torch.models.layers import conv_q, pool_rows, row_sharded
    from codenet_torch.parallel.mesh import band, gather_rows, grid
    sp = grid(dp, spatial).over_spatial
    out = {}
    for name in OPS:
        mod, x, g = op_case(name)
        lo, hi = band(x.shape[2], sp)
        xb = x[:, :, lo:hi].clone().requires_grad_()
        with row_sharded(sp):
            if isinstance(mod, torch.nn.MaxPool2d):
                y = pool_rows(mod, xb)
            else:
                y = conv_q(mod, xb, None)
        glo, ghi = band(g.shape[2], sp)
        y.backward(g[:, :, glo:ghi])
        out[name] = {"y": gather_rows(y.detach(), sp), "dx": xb.grad,
                     "rows": (lo, hi)}
    return out


# -- train steps ----------------------------------------------------------

def u8_batches(n_steps=1):
    """The step batches with uint8 images and colour aug in place of the
    normalised input (the device path: contrast needs the grey mean)."""
    r = np.random.RandomState(23)
    out = []
    for batch in step_batches(n_steps):
        b = len(batch["input"])
        batch = {k: v for k, v in batch.items() if k != "input"}
        batch.update(
            input_u8=r.randint(0, 256, (b, RES, RES, 3)).astype(np.uint8),
            aug_perm=r.randint(0, 6, b).astype(np.int32),
            aug_alphas=r.uniform(-0.4, 0.4, (b, 3)).astype(np.float32),
            aug_light=r.uniform(-0.1, 0.1, (b, 3)).astype(np.float32))
        out.append(batch)
    return out


def grid_steps(dp, spatial=1, qspec=None, dtype=torch.float64,
               n_steps=STEPS, batches=None, extra=()):
    """Train steps from the conditioned init, on this rank's data row's
    rows of each global batch (all of them with dp None): each step's
    stats, the state after each, and the warnings raised."""
    from codenet_torch.engine.trainer import Trainer
    from codenet_torch.parallel.mesh import check_replicas_equal
    flags = list(extra) + (["--spatial_shard", str(spatial)]
                           if spatial > 1 else [])
    opt = task_opt(extra=flags)
    trainer = Trainer(opt, qspec=qspec, device="cpu", dp=dp)
    trainer.model.load_state_dict(conditioned_state(task_opt()),
                                  strict=qspec is None)
    trainer.model.to(dtype)
    trainer.init()
    g = trainer.dp
    lo, hi = (process_batch_slice(GLOBAL_BATCH, g.data_rank, g.data_world)
              if g is not None else (0, GLOBAL_BATCH))
    out = {"stats": [], "states": []}
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        for batch in batches or step_batches(n_steps):
            rows = {k: v[lo:hi] for k, v in batch.items()}
            stats = trainer.train_step(tensors(rows, dtype))
            out["stats"].append({k: v.clone() for k, v in stats.items()})
            out["states"].append({k: v.clone() for k, v in
                                  trainer.model.state_dict().items()})
    out["warnings"] = [str(w.message) for w in caught
                       if "spatial_shard" in str(w.message)]
    check_replicas_equal(trainer.model, g)
    return out


def cache_case(n_shards=2):
    """An image cache of 8 seeded 72x80 frames and one global batch that
    warps 4 of them to RES^2 with seeded scale-and-shift matrices and
    colour aug; slot-block s reads shard s (n_shards of ceil(8 / n))."""
    r = np.random.RandomState(31)
    images = r.randint(0, 256, (8, 72, 80, 3)).astype(np.uint8)
    rps = -(-len(images) // n_shards)
    per = GLOBAL_BATCH // n_shards
    idx = np.concatenate([s * rps + r.permutation(rps)[:per]
                          for s in range(n_shards)]).astype(np.int32)
    scale = r.uniform(0.9, 1.3, GLOBAL_BATCH)
    warp = np.zeros((GLOBAL_BATCH, 2, 3), np.float32)
    warp[:, 0, 0] = warp[:, 1, 1] = scale
    warp[:, :, 2] = r.uniform(-6, 6, (GLOBAL_BATCH, 2))
    batch = {k: v for k, v in step_batches(1)[0].items() if k != "input"}
    batch.update(
        img_idx=idx, warp_ti=warp,
        aug_perm=r.randint(0, 6, GLOBAL_BATCH).astype(np.int32),
        aug_alphas=r.uniform(-0.4, 0.4, (GLOBAL_BATCH, 3)).astype(
            np.float32),
        aug_light=r.uniform(-0.1, 0.1, (GLOBAL_BATCH, 3)).astype(
            np.float32))
    return images, batch


def cache_step(dp, spatial=1):
    """One --device_cache_shard step through Trainer.run_epoch on the
    grid (dp None: one process, the whole unsharded cache): the stats and
    the state."""
    from codenet_torch.data.device_cache import ImageCache
    from codenet_torch.engine.trainer import Trainer
    flags = ["--device_cache_shard"] + (["--spatial_shard", str(spatial)]
                                        if spatial > 1 else [])
    opt = task_opt(extra=flags)
    images, batch = cache_case()
    cache = ImageCache(images, np.full((len(images), 2), (72, 80),
                                       np.int32))
    trainer = Trainer(opt, device="cpu", dp=dp)
    trainer.model.load_state_dict(conditioned_state(task_opt()))
    trainer.init()
    g = trainer.dp
    if g is None:
        trainer.image_cache = cache.to_device("cpu")
    else:
        trainer.image_cache = cache.to_device("cpu", shard=True,
                                              dp=g.over_data)
        trainer.cache_shard_rows = cache.shard_rows
        lo, hi = process_batch_slice(GLOBAL_BATCH, g.data_rank,
                                     g.data_world)
        batch = {k: v[lo:hi] for k, v in batch.items()}
    stats = trainer.run_epoch("train", 1, [batch])
    return {"stats": stats, "state": {
        k: v.clone() for k, v in trainer.model.state_dict().items()}}


def grid4(dp):
    from codenet_torch.models.layers import QuantSpec
    from codenet_torch.parallel.mesh import grid
    grid(dp, 2)
    grid(dp, 4)  # every rank makes every group, in one order
    return {"ops_sp2": op_results(dp, 2), "ops_sp4": op_results(dp, 4),
            "fp32": grid_steps(dp, 2),
            "qat": grid_steps(dp, 2, QuantSpec(wt_percentile=True,
                                               act_clamp=True)),
            "early_gather": grid_steps(dp, 4, n_steps=1),
            "cache": cache_step(dp, 2)}


def color_case():
    """Seeded [0, 1] f32 images and colour-aug state (every image runs
    the contrast op)."""
    r = np.random.RandomState(41)
    images = torch.from_numpy(r.rand(GLOBAL_BATCH, RES, 24, 3).astype(
        np.float32))
    perm = torch.from_numpy(r.randint(0, 6, GLOBAL_BATCH))
    alphas = torch.from_numpy(r.uniform(-0.4, 0.4, (GLOBAL_BATCH, 3)))
    light = torch.from_numpy(r.uniform(-0.1, 0.1, (GLOBAL_BATCH, 3)))
    return images, perm, alphas, light


def color_band(dp, spatial):
    """This rank's band of the colour aug, its grey mean over the
    spatial group (device_aug.color_norm_f01's rows_of)."""
    from codenet_torch.data.device_aug import color_norm_f01
    from codenet_torch.parallel.mesh import band, grid
    sp = grid(dp, spatial).over_spatial
    images, perm, alphas, light = color_case()
    lo, hi = band(RES, sp)
    opt = task_opt()
    return {"rows": (lo, hi), "out": color_norm_f01(
        images[:, lo:hi], perm, alphas, light, opt.mean, opt.std,
        (RES, sp))}


def grid_of_trainer(dp, arch):
    """The grid coordinates (rank, world, spatial, data rows) of a Trainer
    built for `arch` with --spatial_shard 2."""
    from codenet_torch.engine.trainer import Trainer
    g = Trainer(task_opt(extra=["--spatial_shard", "2", "--arch", arch]),
                device="cpu", dp=dp).dp
    return g.rank, g.world, g.spatial, g.data_world


def grid2(dp):
    from codenet_torch.models.layers import QuantSpec
    return {"res_18_grid": grid_of_trainer(dp, "res_18"),
            "fp32": grid_steps(dp, 2),
            "qat": grid_steps(dp, 2, QuantSpec(wt_percentile=True,
                                               act_clamp=True)),
            "fp32_f32": grid_steps(dp, 2, dtype=torch.float32),
            "color": color_band(dp, 2),
            "u8": grid_steps(dp, 2, dtype=torch.float32, n_steps=1,
                             batches=u8_batches())}


def grid3(dp):
    return {"whole": grid_steps(dp, 3, n_steps=1)}


def grid_engine(dp):
    """dp 1 x sp 2 (test_torch_dp_engine.py): an FP32 epoch of 3 f64
    steps through the graphed epoch engine and through the per-step
    path, and the engine's epoch again taking its graph branch on the
    CPU (torch_parallel_worker.graphed_on_cpu)."""
    from torch_parallel_worker import as_float, epoch_run, graphed_on_cpu
    batches = [as_float(b) for b in step_batches(3)]
    flags = ["--spatial_shard", "2"]
    out = {("engine" if scan else "per_step"): epoch_run(
        dp, scan, batches, extra=flags) for scan in (True, False)}
    graphed, rows = graphed_on_cpu(dp, lambda: epoch_run(
        dp, True, batches, extra=flags))
    out["graph_branch"] = dict(graphed, graph_rows=rows)
    return out


def references():
    """The one-process runs every scenario is held to."""
    from codenet_torch.models.layers import QuantSpec
    return {"fp32": grid_steps(None),
            "qat": grid_steps(None, qspec=QuantSpec(wt_percentile=True,
                                                    act_clamp=True)),
            "u8": grid_steps(None, dtype=torch.float32, n_steps=1,
                             batches=u8_batches()),
            "cache": cache_step(None)}


SCENARIOS = {"grid4": grid4, "grid2": grid2, "grid3": grid3,
             "engine": grid_engine}
# launched by test_torch_dp_engine.py alone
ENGINE_WORLDS = {"engine": 2}


def _rank(dp, scenario, out_dir):
    torch.set_num_threads(1)
    torch.save(SCENARIOS[scenario](dp),
               os.path.join(out_dir, "rank{}.pt".format(dp.rank)))


if __name__ == "__main__":
    name = sys.argv[1]
    launch(_rank, ["cpu"] * {**WORLDS, **ENGINE_WORLDS}[name],
           args=(name, sys.argv[2]))
