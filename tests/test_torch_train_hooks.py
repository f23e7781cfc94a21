"""The trainer's val-side hooks of the port against the JAX package's.

One sampler batch of the synthetic sets (ctdet on VOC, multi_pose on
COCO keypoints, ddd on KITTI, exdet on COCO extreme points) goes to both
packages with the same head outputs: a stand-in model returns seeded
heads in each framework, so that what is compared is what the hooks and
the oracle step add to the network (the heads themselves are held
against the JAX model per task in tests/test_torch_{model,multi_pose,
ddd,exdet}.py).

- the --eval_oracle_* val step (engine/trainer.py::make_oracle_val_step
  against the JAX package's): every probe, each val loss stat within
  1e-5;
- --debug (engine/train_hooks.py `debug`): per task, the same drawing
  calls in the same order (the detections drawn, their thresholds, the
  heatmaps blended) with their arguments within 1e-4 (uint8 images
  within one level), and the renders;
- --test (`save_result`): the decoded, back-projected detections of
  ctdet, multi_pose and ddd within 1e-3 px and 1e-5 of score; exdet
  saves none in either package.
"""

import numpy as np
import pytest

cv2 = pytest.importorskip("cv2")

import jax.numpy as jnp
import torch

from test_torch_common import rng
from test_torch_debugger import _bird_view
from test_torch_faults import data_root  # noqa: F401

from codenet_tpu import config as jcfg
from codenet_tpu.engine import train_hooks as JH
from codenet_tpu.engine import trainer as JT
from codenet_tpu.models.losses import LOSS_FACTORY as JAX_LOSSES
from codenet_torch import config as tcfg
from codenet_torch.data.datasets import get_dataset
from codenet_torch.data.loader import DataLoader
from codenet_torch.engine import train_hooks as TH
from codenet_torch.engine import trainer as TT
from codenet_torch.engine.trainer import batch_to_device
from codenet_torch.models.losses import LOSS_FACTORY

# task -> (dataset, size flags)
TASKS = {"ctdet": ("pascal", ["--input_res", "64"]),
         "multi_pose": ("coco_hp", ["--input_res", "64"]),
         "ddd": ("kitti", ["--input_h", "96", "--input_w", "256"]),
         "exdet": ("coco", ["--input_res", "64", "--K", "6"])}


def _opts(task, root, *extra):
    dataset, size = TASKS[task]
    args = [task, "--dataset", dataset, "--arch", "shufflenetv2", *size,
            "--gpus", "-1", "--data_dir", root, "--batch_size", "2",
            "--num_workers", "1", *extra]
    return (tcfg.update_dataset_info_and_set_heads(
                tcfg.parse(args), tcfg.DATASET_SPECS[dataset]),
            jcfg.update_dataset_info_and_set_heads(
                jcfg.parse(args), jcfg.DATASET_SPECS[dataset]))


def _val_batch(opt):
    """The first val batch (2 images, meta as a list) of the port's
    sampler, as numpy."""
    ds = get_dataset(opt.dataset, opt.task)(opt, "val")
    return next(iter(DataLoader(ds, 2, shuffle=False, num_workers=1)))


def _heads(opt, n, seed):
    """Seeded NHWC head outputs at the output stride; heatmap logits
    around -5: scores spread over the thresholds (0.1 and others)."""
    r = rng(seed)
    h, w = opt.input_h // opt.down_ratio, opt.input_w // opt.down_ratio
    out = {}
    for name, c in sorted(opt.heads.items()):
        if name.startswith("hm"):
            out[name] = (r.randn(n, h, w, c) * 2 - 5).astype(np.float32)
        else:
            out[name] = (r.randn(n, h, w, c) * 2).astype(np.float32)
    return out


class _PortModel(torch.nn.Module):
    def __init__(self, heads):
        super().__init__()
        self.heads = heads

    def forward(self, inp, **kw):
        return {k: torch.from_numpy(v).to(inp.device)
                for k, v in self.heads.items()}


class _JaxModel:
    def __init__(self, heads):
        self.heads = heads

    def apply(self, variables, inp, train=False, **kw):
        return {k: jnp.asarray(v) for k, v in self.heads.items()}


def _split(batch):
    meta = batch.get("meta")
    jbatch = {k: jnp.asarray(v) for k, v in batch.items() if k != "meta"}
    return batch_to_device(batch, "cpu"), jbatch, meta


# -- the oracle val step -----------------------------------------------------------

ORACLE_CASES = {
    "ctdet-hm": ("ctdet", ["hm"]),
    "ctdet-wh-offset": ("ctdet", ["wh", "offset"]),
    "multi_pose-hmhp-kps-hp_offset": ("multi_pose",
                                      ["hmhp", "kps", "hp_offset"]),
    "multi_pose-hm-wh-offset": ("multi_pose", ["hm", "wh", "offset"]),
    "ddd-dep": ("ddd", ["dep"]),
    "ddd-hm-wh-offset": ("ddd", ["hm", "wh", "offset"]),
}


@pytest.mark.parametrize("case", list(ORACLE_CASES))
def test_oracle_val_step_matches_jax(case, data_root):  # noqa: F811
    """Each probe replaces its head with the ground truth (logits of the
    clipped heatmap for hm and hm_hp, the nearest-object fill for the
    rest): the val loss stats equal the JAX oracle step's on the same
    batch and heads, and a probed regression loss is 0."""
    task, probes = ORACLE_CASES[case]
    flags = ["--eval_oracle_" + p for p in probes]
    opt, jopt = _opts(task, data_root, *flags)
    batch = _val_batch(opt)
    heads = _heads(opt, 2, seed=120)
    tbatch, jbatch, _ = _split(batch)
    step = TT.make_oracle_val_step(
        _PortModel(heads), LOSS_FACTORY[task], TT.LossOpts(opt), opt,
        np.asarray(opt.mean, np.float32), np.asarray(opt.std, np.float32))
    jstep = JT.make_oracle_val_step(_JaxModel(heads), JAX_LOSSES[task],
                                    JT.LossOpts(jopt), jopt)
    stats = {k: float(v) for k, v in step(tbatch).items()}
    ref = {k: float(v) for k, v in jstep(None, jbatch).items()}
    assert set(stats) == set(ref)
    for k in ref:
        np.testing.assert_allclose(stats[k], ref[k], rtol=1e-5, atol=1e-6,
                                   err_msg=k)
    # the stats without a probe differ: the probes did replace heads
    plain = TT.make_val_step(
        _PortModel(heads), LOSS_FACTORY[task], TT.LossOpts(opt),
        np.asarray(opt.mean, np.float32), np.asarray(opt.std, np.float32),
        opt.down_ratio, opt.num_classes, (opt.input_h, opt.input_w))
    unprobed = {k: float(v) for k, v in plain(tbatch).items()}
    assert any(abs(unprobed[k] - stats[k]) > 1e-3 for k in stats)
    # the probes whose loss reads the filled map only at its own centres
    # (dep is decoded from the filled map first; hp_offset's joints may
    # share a cell, where the fill keeps one)
    zeroed = {"wh": "wh_loss", "offset": "off_loss", "kps": "hp_loss"}
    for p in probes:
        if p in zeroed and zeroed[p] in stats:
            assert stats[zeroed[p]] == 0, (p, stats)


# -- --debug and --test's save_result ---------------------------------------------

DRAWS = ("add_img", "add_blend_img", "add_coco_bbox", "add_coco_hp",
         "add_ct_detection", "add_3d_detection", "add_bird_view")


def _record(hooks, calls, debuggers, jax_bird=False):
    """Make `hooks` hand out debuggers that log every drawing call
    (name, args) before drawing. The JAX Debugger's add_bird_view raises
    on cv2 (tests/test_torch_debugger.py); there the log takes the call
    and the view is drawn as that code means it."""
    make = hooks._debugger

    def debugger():
        # the class colours are numpy draws: alike in both packages
        np.random.seed(11)
        dbg = make()
        for name in DRAWS:
            draw = getattr(dbg, name)

            def logged(*args, _draw=draw, _name=name, **kw):
                calls.append((_name, args, kw))
                if _name == "add_bird_view" and jax_bird:
                    dbg.imgs[kw["img_id"]] = _bird_view(
                        dbg.colors, args[0],
                        center_thresh=kw["center_thresh"])
                    return None
                return _draw(*args, **kw)
            setattr(dbg, name, logged)
        debuggers.append(dbg)
        return dbg
    hooks._debugger = debugger


def _assert_close(a, b, where):
    """Nested call arguments: containers by structure, uint8 images
    within one level, other arrays within 1e-4, scalars and strings
    equal."""
    if isinstance(a, dict):
        assert sorted(a) == sorted(b), where
        for k in a:
            _assert_close(a[k], b[k], "{}[{}]".format(where, k))
    elif isinstance(a, (list, tuple)) and not np.isscalar(a):
        assert len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_close(x, y, "{}[{}]".format(where, i))
    elif isinstance(a, (str, bool, type(None))):
        assert a == b, where
    else:
        x = np.asarray(a)
        y = np.asarray(b)
        assert x.shape == y.shape, where
        if x.dtype == np.uint8:
            assert int(np.abs(x.astype(int) - y.astype(int)).max(
                initial=0)) <= 1, where
        else:
            np.testing.assert_allclose(x.astype(np.float64),
                                       y.astype(np.float64), rtol=1e-4,
                                       atol=1e-4, err_msg=where)


def _assert_results_close(port, ref, score_col):
    """save_result's {class: rows}: the same classes and rows, in order,
    within 1e-3 px (boxes, keypoints, 3D dims and locations) and 1e-5 of
    score. Rows of score 0 (cells the peak pooling zeroed, which fill the
    top K when fewer peaks exist) are tied, and each framework orders
    ties its own way (ROADMAP's "Ties"): they are counted, not matched."""
    assert sorted(port) == sorted(ref)
    for cls in ref:
        a = np.asarray(ref[cls], np.float64).reshape(len(ref[cls]), -1)
        b = np.asarray(port[cls], np.float64).reshape(len(port[cls]), -1)
        assert a.shape == b.shape, cls
        keep = a[:, score_col] > 0
        assert (keep == (b[:, score_col] > 0)).all(), cls
        np.testing.assert_allclose(b[keep], a[keep], rtol=1e-5, atol=1e-3,
                                   err_msg=str(cls))


@pytest.mark.parametrize("task", list(TASKS))
def test_debug_and_save_result_match_jax(task, data_root, tmp_path):  # noqa: F811
    """Both packages' TrainHooks on the same val batch and heads, through
    their public `forward`, `debug` and `save_result`: the same drawing
    calls, renders within one level, the same decoded results."""
    opt, jopt = _opts(task, data_root, "--debug",
                      "3" if task == "exdet" else "1", "--test")
    opt.debug_dir = str(tmp_path / "port")
    jopt.debug_dir = str(tmp_path / "jax")
    batch = _val_batch(opt)
    heads = _heads(opt, 2, seed=121)
    if task == "exdet":
        # a box needs four extreme points and a centre of one class, its
        # mean score over 0.1: class 0's points stand out in every map
        for name in heads:
            if name.startswith("hm"):
                heads[name][..., 0] += 6
    tbatch, jbatch, meta = _split(batch)
    hooks = TH.TrainHooks(opt, _PortModel(heads))
    jhooks = JH.TrainHooks(jopt, _JaxModel(heads))
    calls, jcalls, dbgs, jdbgs = [], [], [], []
    _record(hooks, calls, dbgs)
    _record(jhooks, jcalls, jdbgs, jax_bird=True)

    fwd = hooks.forward(tbatch)
    jfwd = jhooks.forward(None, jbatch)
    hooks.debug(tbatch, meta, 0, phase="val", fwd_out=fwd)
    jhooks.debug(None, jbatch, meta, 0, phase="val", fwd_out=jfwd)
    assert [(n, kw.get("img_id")) for n, _, kw in calls] == \
        [(n, kw.get("img_id")) for n, _, kw in jcalls]
    drawn = sum(n in ("add_coco_bbox", "add_ct_detection",
                      "add_3d_detection") for n, _, _ in calls)
    assert drawn > 0
    for i, ((name, args, kw), (_, jargs, jkw)) in enumerate(
            zip(calls, jcalls)):
        _assert_close(args, jargs, "{} {} args".format(i, name))
        _assert_close(kw, jkw, "{} {} kwargs".format(i, name))
    (dbg,), (jdbg,) = dbgs, jdbgs
    assert list(dbg.imgs) == list(jdbg.imgs)
    for name, ref in jdbg.imgs.items():
        diff = np.abs(dbg.imgs[name].astype(int) - ref.astype(int))
        # a line may land one pixel over where a coordinate sits within
        # 1e-4 of an integer; none does here
        assert diff.max() <= 1, name

    results, jresults = {}, {}
    hooks.save_result(tbatch, meta, results, fwd_out=fwd)
    jhooks.save_result(None, jbatch, meta, jresults, fwd_out=jfwd)
    assert sorted(results) == sorted(jresults)
    if task == "exdet":
        assert results == {}
        return
    (img_id,) = jresults
    assert img_id == meta[0]["img_id"]
    # the score: after the box in ctdet and multi_pose rows, last in ddd's
    score_col = -1 if task == "ddd" else 4
    _assert_results_close(results[img_id], jresults[img_id], score_col)
    assert sum((np.asarray(v).reshape(len(v), -1)[:, score_col] > 0.1).sum()
               for v in results[img_id].values()) > 0
