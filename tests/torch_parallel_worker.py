"""Rank bodies of the port's data-parallel tests (test_torch_parallel.py,
test_torch_multihost.py), and the inputs they share with the tests'
one-process references. Run as

    python tests/torch_parallel_worker.py SCENARIO OUT_DIR

which spawns two gloo ranks on the CPU through
``codenet_torch.parallel.launch``; rank k writes OUT_DIR/rank<k>.pt.
Imports nothing of JAX, so the ranks start in seconds. Every input is
made with numpy from a seed and is the same on every rank; each rank
keeps its rows [lo, hi) of each global batch (process_batch_slice).
"""

import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

from codenet_torch import config as cfg  # noqa: E402
from codenet_torch.parallel import launch, process_batch_slice  # noqa: E402

GLOBAL_BATCH = 4
RES = 64
LR = 1.25e-4
STEPS = 3
HEADS_KEEP = (".4",)  # the BN before each head's last conv keeps its bias
BN_SHIFT = 3.0

# task -> (dataset, the command line's extra flags)
TASKS = {"ctdet": ("pascal", []), "multi_pose": ("coco_hp", []),
         "ddd": ("kitti", []), "exdet": ("coco", [])}


def task_opt(task="ctdet", extra=(), batch=GLOBAL_BATCH):
    dataset, flags = TASKS[task]
    args = [task, "--dataset", dataset, "--arch", "shufflenetv2",
            "--input_res", str(RES), "--batch_size", str(batch), "--gpus",
            "-1"] + flags + list(extra)
    return cfg.update_dataset_info_and_set_heads(
        cfg.parse(args), cfg.DATASET_SPECS[dataset])


def rows_of(tree, dp):
    """A rank's rows of every (batch-major) array of `tree`."""
    lo, hi = process_batch_slice(GLOBAL_BATCH, dp.rank, dp.world)
    return {k: v[lo:hi] for k, v in tree.items()}


def tensors(tree, dtype=None):
    out = {}
    for k, v in tree.items():
        t = torch.from_numpy(np.ascontiguousarray(v))
        out[k] = t.to(dtype) if dtype is not None and t.is_floating_point() \
            else t
    return out


# -- unit inputs ---------------------------------------------------------

def bn_case():
    r = np.random.RandomState(5)
    x = r.randn(GLOBAL_BATCH, 6, 5, 7) * 2.0 + 3.0
    g = r.randn(GLOBAL_BATCH, 6, 5, 7)
    return x, g


def act_case():
    r = np.random.RandomState(6)
    return [r.randn(GLOBAL_BATCH, 3, 9, 9) * (1.0 + k) for k in range(2)]


def loss_case(task, positives):
    """(outputs, batch) of `task` at 8x8, 6 objects an image; positives:
    'all' (every image has objects), 'rank1' (only the last two images:
    rank 0 holds none) or 'none'."""
    opt = task_opt(task)
    r = np.random.RandomState(sum(map(ord, task + positives)))
    n, h, w, m = GLOBAL_BATCH, 8, 8, 6
    outs = {k: r.randn(n, h, w, c) for k, c in opt.heads.items()}
    has = np.ones(n, bool)
    if positives == "rank1":
        has[:n // 2] = False
    elif positives == "none":
        has[:] = False

    def heat(c):
        hm = r.rand(n, h, w, c) * 0.9
        for i in np.flatnonzero(has):
            hm[i, r.randint(h), r.randint(w), r.randint(c)] = 1.0
        return hm

    def mask(*shape):
        k = (r.rand(n, *shape) < 0.7).astype(np.uint8)
        k[~has] = 0
        return k
    ind = r.randint(0, h * w, (n, m)).astype(np.int64)
    batch = {"ind": ind, "reg_mask": mask(m),
             "wh": r.uniform(1, 9, (n, m, 2)), "reg": r.rand(n, m, 2)}
    if task == "ctdet":
        batch["hm"] = heat(opt.num_classes)
    elif task == "multi_pose":
        batch.update(hm=heat(1), hm_hp=heat(17), hps=r.randn(n, m, 34),
                     hps_mask=mask(m, 34),
                     hp_offset=r.rand(n, m * 17, 2),
                     hp_ind=r.randint(0, h * w, (n, m * 17)),
                     hp_mask=mask(m * 17).astype(np.int64))
    elif task == "ddd":
        rotbin = r.randint(0, 2, (n, m, 2)).astype(np.int64)
        rotbin[~has] = 0
        batch.update(hm=heat(opt.num_classes), dep=r.uniform(5, 40, (n, m, 1)),
                     dim=r.uniform(1, 4, (n, m, 3)), rotbin=rotbin,
                     rotres=r.uniform(-1, 1, (n, m, 2)), rot_mask=mask(m))
    else:
        for p in "tlbr":
            batch["hm_" + p] = heat(opt.num_classes)
            batch["reg_" + p] = r.rand(n, m, 2)
            batch["ind_" + p] = r.randint(0, h * w, (n, m))
        batch["hm_c"] = heat(opt.num_classes)
    return opt, outs, batch


def unit_results(dp):
    """Synced BN, the QAT ranges and every task's loss on this rank (or on
    the whole batch with dp None), f64."""
    from codenet_torch.engine.trainer import LossOpts
    from codenet_torch.models.layers import (QuantAct, QuantSpec, bn,
                                             set_data_parallel)
    from codenet_torch.models.losses import LOSS_FACTORY
    lo, hi = process_batch_slice(GLOBAL_BATCH, dp.rank, dp.world) \
        if dp is not None else (0, GLOBAL_BATCH)
    out = {}
    x, g = bn_case()
    m = bn(x.shape[1]).double()
    with torch.no_grad():
        m.weight.uniform_(0.5, 1.5, generator=torch.Generator()
                          .manual_seed(1))
        m.bias.uniform_(-0.5, 0.5, generator=torch.Generator()
                        .manual_seed(2))
    set_data_parallel(m, dp)
    xt = torch.from_numpy(x[lo:hi]).requires_grad_()
    y = m(xt)
    (y * torch.from_numpy(g[lo:hi])).sum().backward()
    m(torch.from_numpy(x[lo:hi] * 0.5 + 1.0))  # a second EMA update
    out["bn"] = {"y": y.detach(), "dx": xt.grad, "dweight": m.weight.grad,
                 "dbias": m.bias.grad, **{k: v.clone() for k, v in
                                          m.state_dict().items()}}
    for pct in (False, True):
        act = QuantAct(QuantSpec(act_percentile=pct)).double()
        set_data_parallel(act, dp)
        ys = [act(torch.from_numpy(xa[lo:hi]), update=True)
              for xa in act_case()]
        out["act_pct" if pct else "act"] = {
            "x_min": act.x_min.clone(), "x_max": act.x_max.clone(),
            "y": ys[-1]}
    for task in TASKS:
        for positives in ("all", "rank1", "none"):
            opt, outs, batch = loss_case(task, positives)
            touts = {k: torch.from_numpy(v[lo:hi]).requires_grad_()
                     for k, v in outs.items()}
            loss, stats = LOSS_FACTORY[task](
                [touts], tensors({k: v[lo:hi] for k, v in batch.items()}),
                LossOpts(opt, dp))
            loss.backward()
            out["loss_{}_{}".format(task, positives)] = {
                "stats": {k: torch.as_tensor(v).detach()
                          for k, v in stats.items()},
                "grads": {k: t.grad for k, t in touts.items()}}
    return out


# -- train steps ----------------------------------------------------------

def conditioned_state(opt):
    """The port's seeded init with every BN bias raised by BN_SHIFT but
    those before the heads' last convs (chip_smoke.py::conditioned_init;
    test_torch_train.py::test_train_step_matches_jax says why)."""
    from codenet_torch.models import create_model
    model = create_model(opt.arch, opt.heads, opt.head_conv, device="cpu",
                         generator=torch.Generator().manual_seed(opt.seed))
    keep = {h + ".4" for h in opt.heads}
    with torch.no_grad():
        for name, mod in model.named_modules():
            if isinstance(mod, torch.nn.BatchNorm2d) and name not in keep:
                mod.bias.add_(BN_SHIFT)
    return model.state_dict()


def step_batches(n_steps=STEPS, b=GLOBAL_BATCH, res=RES):
    """Global batches of host-normalised inputs and dense ctdet targets
    (3 objects an image)."""
    r = np.random.RandomState(11)
    out_res = res // 4
    batches = []
    for _ in range(n_steps):
        ct = r.randint(0, out_res, (b, 3, 2))
        hm = r.rand(b, out_res, out_res, 20).astype(np.float32) * 0.5
        hm[np.arange(b)[:, None], ct[..., 1], ct[..., 0],
           r.randint(0, 20, (b, 3))] = 1.0
        ind = np.zeros((b, 50), np.int64)
        ind[:, :3] = ct[..., 1] * out_res + ct[..., 0]
        batches.append({
            "input": r.randn(b, res, res, 3).astype(np.float32),
            "hm": hm, "ind": ind,
            "reg_mask": (np.arange(50) < 3).astype(np.uint8)[None]
            .repeat(b, 0),
            "wh": r.uniform(2, 12, (b, 50, 2)).astype(np.float32),
            "reg": r.rand(b, 50, 2).astype(np.float32)})
    return batches


def run_steps(dp, qspec=None, dtype=torch.float64, n_steps=STEPS,
              keep_grads_after=None):
    """`n_steps` train steps of the 64^2 model from `conditioned_state`,
    on this rank's rows (all of them with dp None): the stats of each
    step, the final state, and the gradients of step `keep_grads_after`
    with the state after it."""
    from codenet_torch.engine.trainer import Trainer
    opt = task_opt()
    trainer = Trainer(opt, qspec=qspec, device="cpu", dp=dp)
    # QAT: the activation ranges start at 0, as a QAT run from an FP32
    # checkpoint does
    trainer.model.load_state_dict(conditioned_state(opt),
                                  strict=qspec is None)
    trainer.model.to(dtype)
    trainer.init()
    out = {"stats": []}
    for i, batch in enumerate(step_batches(n_steps)):
        if dp is not None:
            batch = rows_of(batch, dp)
        stats = trainer.train_step(tensors(batch, dtype))
        out["stats"].append({k: v.clone() for k, v in stats.items()})
        if i + 1 == keep_grads_after:
            out["grads"] = {n: p.grad.clone() for n, p in
                            trainer.model.named_parameters()
                            if p.grad is not None}
            out["state_1"] = {k: v.clone() for k, v in
                              trainer.model.state_dict().items()}
    out["state"] = {k: v.clone()
                    for k, v in trainer.model.state_dict().items()}
    return out


def step_results(dp):
    from codenet_torch.models.layers import QuantSpec
    qspec = QuantSpec(wt_percentile=True, act_clamp=True)
    return {"fp32_f64": run_steps(dp),
            "qat_f64": run_steps(dp, qspec),
            "fp32_f32": run_steps(dp, dtype=torch.float32,
                                  keep_grads_after=1)}


# -- the sharded image cache ----------------------------------------------

def cache_case(n_ranks=2, b=GLOBAL_BATCH, res=RES):
    """The JAX dryrun's phase-3 batch at `n_ranks`: raw frames as the
    cache stack, identity warps and colour state, slot-block s of the
    batch drawn from cache shard s, a heatmap peak at (8, 8)."""
    r = np.random.RandomState(0)
    r.randn(b, res, res, 3)  # the dryrun's phase-1 input draw
    images = r.randint(0, 255, (b, res, res, 3)).astype(np.uint8)
    out_res = res // 4
    rps = -(-b // n_ranks)
    batch = {
        "img_idx": np.concatenate([np.arange(s * rps, s * rps + b // n_ranks)
                                   for s in range(n_ranks)]).astype(np.int32),
        "warp_ti": np.tile(np.array([[1, 0, 0], [0, 1, 0]], np.float32),
                           (b, 1, 1)),
        "aug_perm": np.zeros((b,), np.int32),
        "aug_alphas": np.zeros((b, 3), np.float32),
        "aug_light": np.zeros((b, 3), np.float32),
        "hm": np.zeros((b, out_res, out_res, 20), np.float32),
        "wh": np.zeros((b, 50, 2), np.float32),
        "reg": np.zeros((b, 50, 2), np.float32),
        "ind": np.zeros((b, 50), np.int64),
        "reg_mask": np.ones((b, 50), np.uint8)}
    batch["hm"][:, 8, 8, 0] = 1.0
    batch["ind"][:, 0] = 8 * out_res + 8
    return images, batch


def cache_results(dp):
    """One --device_cache_shard step through Trainer.run_epoch (routing
    check and row offset included); with dp None, the whole batch on the
    unsharded cache."""
    from codenet_torch.data.device_cache import ImageCache
    from codenet_torch.engine.trainer import Trainer
    opt = task_opt(extra=["--device_cache_shard"])
    images, batch = cache_case()
    cache = ImageCache(images, np.full((len(images), 2), RES, np.int32))
    trainer = Trainer(opt, device="cpu", dp=dp)
    trainer.model.load_state_dict(conditioned_state(opt))
    trainer.init()
    trainer.image_cache = cache.to_device("cpu", shard=dp is not None,
                                          dp=dp)
    if dp is not None:
        trainer.cache_shard_rows = cache.shard_rows
        batch = rows_of(batch, dp)
    stats = trainer.run_epoch("train", 1, [batch])
    return {"stats": stats, "rows": trainer.image_cache.clone(),
            "state": {k: v.clone()
                      for k, v in trainer.model.state_dict().items()}}


# -- card checks (tests/test_torch_cuda.py) --------------------------------

def card_bn_rank(dp, out_dir):
    """Synced BN in f32 on this rank's device (gloo ranks may share a
    card): its rows' output and dx, its share of the weight's and bias's
    gradients, the running statistics."""
    from codenet_torch.models.layers import bn, set_data_parallel
    lo, hi = process_batch_slice(GLOBAL_BATCH, dp.rank, dp.world)
    x, g = bn_case()
    m = bn(x.shape[1]).to(dp.device)
    set_data_parallel(m, dp)
    xt = torch.from_numpy(x[lo:hi]).float().to(dp.device).requires_grad_()
    y = m(xt)
    (y * torch.from_numpy(g[lo:hi]).float().to(dp.device)).sum().backward()
    out = {"y": y, "dx": xt.grad, "dweight": m.weight.grad,
           "dbias": m.bias.grad, "running_mean": m.running_mean,
           "running_var": m.running_var}
    torch.save({k: v.detach().cpu() for k, v in out.items()},
               os.path.join(out_dir, "rank{}.pt".format(dp.rank)))


def card_kernel_rank(dp, out_dir):
    """Both deform kernels on this rank's card (cuda:LOCAL_RANK) at
    config a's 16x16x256 map, batch 16 (a rank's half of 32), against
    their plain versions there; the launches counted in this process."""
    from codenet_torch.ops import deform_cuda as DC
    r = np.random.RandomState(dp.rank)
    x = torch.from_numpy(r.randn(16, 16, 16, 256).astype(np.float32))
    s = torch.from_numpy(r.uniform(-7, 8, (16, 16, 16, 1))
                         .astype(np.float32))
    w = torch.from_numpy((r.randn(3, 3, 1, 256) * 0.2).astype(np.float32))
    x, s, w = (t.to(dp.device).requires_grad_() for t in (x, s, w))
    g = torch.randn(x.shape, generator=torch.Generator().manual_seed(1)
                    ).to(dp.device)
    DC.LAUNCHES = DC.BWD_LAUNCHES = 0
    out = DC.codesign_deform_conv_fast(x, s, w)
    grads = torch.autograd.grad(out, (x, s, w), g)
    torch.cuda.synchronize(dp.device)
    launches = [DC.LAUNCHES, DC.BWD_LAUNCHES]
    ref = DC.codesign_deform_conv_plain(x, s, w)
    ref_grads = torch.autograd.grad(ref, (x, s, w), g)
    errs = [float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))
            for a, b in zip((out,) + grads, (ref,) + ref_grads)]
    torch.save({"device": str(out.device), "launches": launches,
                "rel_errs": errs},
               os.path.join(out_dir, "rank{}.pt".format(dp.rank)))


SCENARIOS = {"units": unit_results, "steps": step_results,
             "cache": cache_results}


def _rank(dp, scenario, out_dir):
    torch.set_num_threads(1)
    torch.save(SCENARIOS[scenario](dp),
               os.path.join(out_dir, "rank{}.pt".format(dp.rank)))


if __name__ == "__main__":
    launch(_rank, ["cpu", "cpu"], args=(sys.argv[1], sys.argv[2]))
