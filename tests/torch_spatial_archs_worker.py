"""Rank bodies of the --spatial_shard tests of the other architectures
(test_torch_spatial_archs.py), and the one-process references they are
held to. Run as

    python tests/torch_spatial_archs_worker.py SCENARIO OUT_DIR

which spawns the scenario's gloo ranks on the CPU through
``codenet_torch.parallel.launch``; rank k writes OUT_DIR/rank<k>.pt.
Imports nothing of JAX. Every input is made with numpy from a seed and is
the same on every rank; the ranks of a data row keep that row's rows of
each global batch (process_batch_slice over the data axis).

The cases: res_18, resdcn_18, dlav0_34 and dla_34 at 64^2; hourglass as
a narrow two-stack stand-in at 128^2 (the real ``HourglassNet`` with a
KpModule of n = 2, dims (8, 8, 16), a stem of 8 channels: the full
width in f64 is far too slow for the CPU), whose n = 2 kp modules
bottom out at 8 rows, so they run on bands at sp 2 and 4; and
ShuffleNetV2 with the deform backbone (``deform``: no trainer builds
it, so the Trainer's model is swapped for it, as chip_smoke.py does).

- ``archs2``, two ranks (dp 1 x sp 2): 2 FP32 f64 steps of each arch,
  1 of the deform backbone, 1 of res_18 with rank 1's neck statistics
  perturbed (the step takes rank 0's), and 2 FP32 f32 steps of res_18
  (for the JAX mesh);
- ``archs4``, four ranks: the halo ops of these archs at spatial 2 and 4
  (the 7x7 stride-2 stem, a 1x1 stride-2 downsample, the 3/2/1 and 2/2/0
  max pools), 2 FP32 f64 steps of each arch at dp 2 x sp 2, and one step
  of dlav0_34 at dp 1 x sp 4, where at 64^2 level 5's 2 rows do not
  split: it gathers level 5's input and its banded levels 2-4 apiece.
"""

import contextlib
import functools
import hashlib
import os
import sys
from unittest import mock

import numpy as np
import torch
import torch.nn.functional as F

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

from torch_parallel_worker import (  # noqa: E402
    BN_SHIFT, GLOBAL_BATCH, RES, step_batches, task_opt, tensors)
from codenet_torch.parallel import launch, process_batch_slice  # noqa: E402

STEPS = 2
ARCHS = ("res_18", "resdcn_18", "dlav0_34", "dla_34", "hourglass")
WORLDS = {"archs2": 2, "archs4": 4}
# the narrow hourglass (models/hourglass.py::HourglassNet's keywords)
STAND_IN = dict(cnv_dim=8, n=2, dims=(8, 8, 16), modules=(2, 2, 2),
                pre_dim=8)
# the BN whose ReLU feeds each arch's heads keeps its bias (the heads
# have no BN of their own; chip_smoke.py::HEAD_FEATURE_BNS)
HEAD_FEATURE_BNS = {"res_18": ("deconv_layers.7",),
                    "resdcn_18": ("deconv_layers.16",),
                    "dlav0_34": ("dla_up.ida_2.node_3.1",),
                    "dla_34": ("ida_up.node_2.actf.0",),
                    "hourglass": ("cnvs.0.bn", "cnvs.1.bn")}

# name -> (channels in, rows, kernel, stride, padding, pool): the row
# windows these archs add: res / hourglass's 7x7 stride-2 stem, the
# blocks' 1x1 stride-2 downsample, the 3/2/1 max pool (res) and DLA's
# 2/2/0 Tree pool
OPS = {"stem_7x7_s2": (3, 64, 7, 2, 3, False),
       "down_1x1_s2": (6, 16, 1, 2, 0, False),
       "max_pool_3_2_1": (6, 32, 3, 2, 1, True),
       "max_pool_2_2_0": (6, 32, 2, 2, 0, True)}
OP_WIDTH = 12


def res_of(case):
    return 128 if case == "hourglass" else RES


def case_opt(case, extra=()):
    arch = "shufflenetv2" if case == "deform" else case
    return task_opt(extra=["--arch", arch, "--input_res",
                           str(res_of(case)), *extra])


def build(case, opt):
    """`case`'s model for `opt` (the stand-in hourglass, the deform
    backbone), seeded from opt.seed, on the CPU."""
    from codenet_torch.models import create_model
    from codenet_torch.models.hourglass import HourglassNet
    gen = torch.Generator().manual_seed(opt.seed)
    if case != "hourglass":
        return create_model(opt.arch, opt.heads, opt.head_conv,
                            deform_backbone=case == "deform", device="cpu",
                            generator=gen)
    model = HourglassNet(opt.heads, 2, **STAND_IN)
    model.reset_parameters(gen)
    return model.to(memory_format=torch.channels_last).eval()


@functools.lru_cache(maxsize=None)
def conditioned(case):
    """The seeded init with every BN bias raised by BN_SHIFT but those
    before the heads (torch_parallel_worker.conditioned_state)."""
    model = build(case, case_opt(case))
    keep = {h + ".4" for h, _ in model.heads} if case == "deform" \
        else set(HEAD_FEATURE_BNS[case])
    with torch.no_grad():
        for name, mod in model.named_modules():
            if isinstance(mod, torch.nn.BatchNorm2d) and name not in keep:
                mod.bias.add_(BN_SHIFT)
    return model.state_dict()


def make_trainer(case, opt, dp=None, dtype=torch.float64):
    """A Trainer on `case`'s model from `conditioned`, in `dtype`; its
    model built by `build` (the stand-in, the deform backbone)."""
    from codenet_torch.engine import trainer as T
    swap = mock.patch.object(T, "create_model",
                             lambda *a, **k: build(case, opt)) \
        if case in ("hourglass", "deform") else contextlib.nullcontext()
    with swap:
        trainer = T.Trainer(opt, device="cpu", dp=dp)
    trainer.model.load_state_dict(conditioned(case))
    trainer.model.to(dtype)
    trainer.init()
    return trainer


def state_digest(model):
    """A digest of the bytes of `model`'s state: equal states give equal
    digests."""
    h = hashlib.sha256()
    for v in model.state_dict().values():
        h.update(v.detach().contiguous().numpy().tobytes())
    return h.hexdigest()


def noise_biases(model):
    """The names of the biases whose gradient is 0 in exact arithmetic:
    every DCNv2 of resdcn and dla feeds a train-mode BN, so its bias's
    gradient is rounding noise, and after Adam's steps (eps 1e-8 over a
    gradient of ~1e-13) so is its value, one that two correct runs do
    not share."""
    from codenet_torch.models.deform_modules import ModulatedDeformConvPack
    return [name + ".bias" for name, m in model.named_modules()
            if isinstance(m, ModulatedDeformConvPack) and m.bias is not None]


def arch_steps(dp, case, spatial=1, dtype=torch.float64, n_steps=STEPS,
               perturb=0):
    """Train steps of `case` from `conditioned` on this rank's data row's
    rows of each global batch (all of them with dp None): each step's
    stats and state digest, the final state (one process and rank 0
    alone: the full-width states of every rank would fill a disk) with
    the names of its `noise_biases`, how far the BN running means moved
    after the first step, and the trainer's grid coordinates (rank, world, spatial, data rows). With
    `perturb` k, the neck's BN running means start k * 1e-12 off, as a
    replica's are after a kernel that sums in no fixed order."""
    flags = ["--spatial_shard", str(spatial)] if spatial > 1 else []
    trainer = make_trainer(case, case_opt(case, flags), dp, dtype)
    if perturb:  # a replica's neck statistics a rounding apart
        with torch.no_grad():
            for k, v in trainer.model.state_dict().items():
                if k.startswith("deconv_layers") and k.endswith("_mean"):
                    v.add_(1e-12 * perturb)
    g = trainer.dp
    lo, hi = (process_batch_slice(GLOBAL_BATCH, g.data_rank, g.data_world)
              if g is not None else (0, GLOBAL_BATCH))
    out = {"stats": [], "digests": [], "grid": None if g is None else (
        g.rank, g.world, g.spatial, g.data_world)}

    def means():
        return {k: v.clone() for k, v in trainer.model.state_dict().items()
                if k.endswith("running_mean")}
    for i, batch in enumerate(step_batches(n_steps, res=res_of(case))):
        rows = {k: v[lo:hi] for k, v in batch.items()}
        stats = trainer.train_step(tensors(rows, dtype))
        out["stats"].append({k: v.clone() for k, v in stats.items()})
        out["digests"].append(state_digest(trainer.model))
        if i == 0:
            first = means()
    out["moved"] = sum(float((v - first[k]).abs().sum())
                       for k, v in means().items())
    if g is None or g.rank == 0:
        out["state"] = {k: v.clone()
                        for k, v in trainer.model.state_dict().items()}
        out["noise"] = noise_biases(trainer.model)
    return out


# -- the halo ops ----------------------------------------------------------

def op_case(name):
    """(conv module or None, x, the output's gradient) of op `name`, f64,
    seeded; the conv a `layers.conv` module (its forward takes the
    halo)."""
    from codenet_torch.models.layers import conv
    c, h, k, stride, pad, pool = OPS[name]
    r = np.random.RandomState(sum(map(ord, name)))
    x = torch.from_numpy(r.randn(2, c, h, OP_WIDTH)).contiguous(
        memory_format=torch.channels_last)
    mod, cout = None, c
    if not pool:
        cout = 6
        mod = conv(c, cout, k, stride, pad).double()
        with torch.no_grad():
            mod.weight.copy_(torch.from_numpy(r.randn(*mod.weight.shape)))
    ho = (h + 2 * pad - k) // stride + 1
    wo = (OP_WIDTH + 2 * pad - k) // stride + 1
    return mod, x, torch.from_numpy(r.randn(2, cout, ho, wo))


def op_apply(name, mod, x):
    from codenet_torch.models.layers import max_pool_rows
    _, _, k, stride, pad, pool = OPS[name]
    return max_pool_rows(x, k, stride, pad) if pool else mod(x)


def op_reference(name):
    """The op on the whole map through plain torch (F.conv2d,
    F.max_pool2d): output and dx."""
    mod, x, g = op_case(name)
    _, _, k, stride, pad, pool = OPS[name]
    x = x.clone().requires_grad_()
    y = F.max_pool2d(x, k, stride, pad) if pool \
        else F.conv2d(x, mod.weight, None, stride, pad)
    y.backward(g)
    return y.detach(), x.grad


def op_results(dp, spatial):
    """Each op on this rank's band inside row_sharded: the gathered
    output and the band's dx."""
    from codenet_torch.models.layers import row_sharded
    from codenet_torch.parallel.mesh import band, gather_rows, grid
    sp = grid(dp, spatial).over_spatial
    out = {}
    for name in OPS:
        mod, x, g = op_case(name)
        lo, hi = band(x.shape[2], sp)
        xb = x[:, :, lo:hi].clone().requires_grad_()
        with row_sharded(sp):
            y = op_apply(name, mod, xb)
        glo, ghi = band(g.shape[2], sp)
        y.backward(g[:, :, glo:ghi])
        out[name] = {"y": gather_rows(y.detach(), sp), "dx": xb.grad,
                     "rows": (lo, hi)}
    return out


# -- scenarios ----------------------------------------------------------------

def archs2(dp):
    out = {case: arch_steps(dp, case, 2) for case in ARCHS}
    out["deform"] = arch_steps(dp, "deform", 2, n_steps=1)
    out["sync"] = arch_steps(dp, "res_18", 2, n_steps=1, perturb=dp.rank)
    out["res_18_f32"] = arch_steps(dp, "res_18", 2, dtype=torch.float32)
    return out


def archs4(dp):
    from codenet_torch.parallel.mesh import grid
    grid(dp, 2)
    grid(dp, 4)  # every rank makes every group, in one order
    out = {"ops_sp2": op_results(dp, 2), "ops_sp4": op_results(dp, 4)}
    out.update({case: arch_steps(dp, case, 2) for case in ARCHS})
    out["early"] = arch_steps(dp, "dlav0_34", 4, n_steps=1)
    return out


def references():
    """The one-process runs every scenario is held to."""
    out = {case: arch_steps(None, case) for case in ARCHS}
    out.update({case + "_1": arch_steps(None, case, n_steps=1)
                for case in ("res_18", "dlav0_34", "deform")})  # one-step runs
    return out


SCENARIOS = {"archs2": archs2, "archs4": archs4}


def _rank(dp, scenario, out_dir):
    torch.set_num_threads(1)
    torch.save(SCENARIOS[scenario](dp),
               os.path.join(out_dir, "rank{}.pt".format(dp.rank)))


if __name__ == "__main__":
    name = sys.argv[1]
    launch(_rank, ["cpu"] * WORLDS[name], args=(name, sys.argv[2]))
