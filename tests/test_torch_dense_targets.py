"""The dense training targets (--mse_loss, --dense_wh, --dense_hp) of the
port against the JAX package, on seeded inputs:

- every task's sampler under the flags against the JAX sampler (its cv2
  warp replaced by the port's), train and val splits, one RandomState a
  frame: every target exact in its dtype (NaN where JAX has NaN: an
  MSRA gaussian of std 0), the --host_normalize f32 input within 1e-5;
- the image cache's batch (--device_cache) equal to the host batch field
  for field, and to the JAX sampler's cache sample; two data-parallel
  ranks' rows bit-equal to the one-process batch;
- each loss term against the JAX loss (2e-3) and its gradients w.r.t.
  the heads (5e-3 of each head's max);
- one config-a FP32 step at 64² with --mse_loss --dense_wh against the
  JAX Trainer from the conditioned init (the tolerances of
  test_torch_train.py::test_train_step_matches_jax);
- the ctdet, ddd and exdet detectors serve the same under --mse_loss as
  without, as the JAX detectors do (only multi_pose reads the flag:
  test_torch_multi_pose.py holds it against the JAX detector);
- `cli.main` trains each task on its dense targets.
"""

import types

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from test_torch_common import (HEADS, assert_rank_rows_equal,
                               assert_train_step_matches_jax,
                               raise_bn_biases, rng, to_np)
from test_torch_faults import data_root  # noqa: F401 (a fixture)

cv2 = pytest.importorskip("cv2")

import jax  # noqa: E402

from codenet_tpu import config as jcfg  # noqa: E402
from codenet_tpu.data import device_cache as JDC  # noqa: E402
from codenet_tpu.data import samplers as JS  # noqa: E402
from codenet_tpu.data.datasets import get_dataset as jax_get_dataset  # noqa: E402,E501
from codenet_tpu.engine.trainer import Trainer as JaxTrainer  # noqa: E402
from codenet_tpu.models import losses as JL  # noqa: E402
from codenet_torch import config as tcfg  # noqa: E402
from codenet_torch.data.affine import invert_affine, warp_affine_u8  # noqa: E402,E501
from codenet_torch.data.datasets import get_dataset  # noqa: E402
from codenet_torch.data.device_cache import ImageCache  # noqa: E402
from codenet_torch.data.loader import DataLoader  # noqa: E402
from codenet_torch.engine import detector as TDET  # noqa: E402
from codenet_torch.engine.trainer import LossOpts, Trainer  # noqa: E402
from codenet_torch.models import losses as TL  # noqa: E402

LR = 1.25e-4
# task -> (dataset, size flags)
TASKS = {"ctdet": ("pascal", ["--input_res", "64"]),
         "multi_pose": ("coco_hp", ["--input_res", "64"]),
         "ddd": ("kitti", ["--input_h", "96", "--input_w", "256"]),
         "exdet": ("coco", ["--input_res", "64"])}


def _opt(cfg, task, root, extra=()):
    dataset, size = TASKS[task]
    args = [task, "--dataset", dataset, "--arch", "shufflenetv2",
            "--batch_size", "2", "--gpus", "-1", "--data_dir", root] \
        + size + list(extra)
    return cfg.update_dataset_info_and_set_heads(
        cfg.parse(args), cfg.DATASET_SPECS[dataset])


def _port_warp_in_jax_sampler(monkeypatch):
    real = JS.cv2

    def warp(img, trans, size, flags=None):
        return warp_affine_u8(img, invert_affine(trans), size[1], size[0])

    monkeypatch.setattr(JS, "cv2", types.SimpleNamespace(
        imread=real.imread, warpAffine=warp, INTER_LINEAR=real.INTER_LINEAR))


def _assert_samples_equal(a, b):
    assert set(a) == set(b)
    for k in a:
        if k == "meta":
            assert set(a[k]) == set(b[k])
            for mk in a[k]:
                np.testing.assert_array_equal(a[k][mk], b[k][mk],
                                              err_msg=mk)
            continue
        if k == "input":  # host colour aug: cv2's grey against a matmul
            np.testing.assert_allclose(b[k], a[k], rtol=0, atol=1e-5)
            continue
        assert np.asarray(a[k]).dtype == np.asarray(b[k]).dtype, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


# the fields each case must carry
CASES = {
    "ctdet-mse": ("ctdet", ["--mse_loss"], ["hm"]),
    "ctdet-dense_wh": ("ctdet", ["--dense_wh"],
                       ["hm", "dense_wh", "dense_wh_mask"]),
    "ctdet-mse_dense_wh_host": (
        "ctdet", ["--mse_loss", "--dense_wh", "--host_normalize"],
        ["input", "dense_wh"]),
    "ctdet-dense_wh_cat_spec": ("ctdet", ["--dense_wh", "--cat_spec_wh"],
                                ["dense_wh"]),
    "multi_pose-mse": ("multi_pose", ["--mse_loss"], ["hm", "hps"]),
    "multi_pose-dense_hp": ("multi_pose", ["--dense_hp"],
                            ["dense_hps", "dense_hps_mask"]),
    "multi_pose-mse_dense_hp_rot": (
        "multi_pose", ["--mse_loss", "--dense_hp", "--aug_rot", "0.5"],
        ["dense_hps"]),
    "ddd-mse": ("ddd", ["--mse_loss", "--aug_ddd", "0.5"], ["hm"]),
    "exdet-mse": ("exdet", ["--mse_loss"], ["hm_t", "hm_c"]),
}


@pytest.mark.parametrize("case", list(CASES))
def test_sampler_matches_jax(data_root, monkeypatch, case):
    """Same RandomState, same sample: the dense targets of the flags
    (MSRA heatmaps, dense wh and its mask in place of wh, dense joint
    offsets and their mask in place of hps) and every other field."""
    task, extra, fields = CASES[case]
    _port_warp_in_jax_sampler(monkeypatch)
    drawn = 0
    for split in ("train", "val"):
        jds = jax_get_dataset(TASKS[task][0], task)(
            _opt(jcfg, task, data_root, extra), split)
        tds = get_dataset(TASKS[task][0], task)(
            _opt(tcfg, task, data_root, extra), split)
        for i in range(len(tds)):
            a = jds.get_sample(i, rng=np.random.RandomState(150 + i))
            b = tds.get_sample(i, rng=np.random.RandomState(150 + i))
            _assert_samples_equal(a, b)
            assert all(f in b for f in fields)
            assert "wh" not in b or "--dense_wh" not in extra
            assert "hps" not in b or "--dense_hp" not in extra
            drawn += int(np.nansum(b[fields[-1]]) != 0)
    assert drawn > 0


def test_cache_batch_equals_host_batch(data_root):
    """--device_cache --mse_loss --dense_wh: the cache sample carries the
    dense hm and dense wh drawn on the host, equal to the host (device
    warp) sample's field for field and to the JAX cache sample."""
    extra = ["--mse_loss", "--dense_wh"]
    host = get_dataset("pascal", "ctdet")(
        _opt(tcfg, "ctdet", data_root, extra), "train")
    tds = get_dataset("pascal", "ctdet")(
        _opt(tcfg, "ctdet", data_root, extra + ["--device_cache"]), "train")
    jds = jax_get_dataset("pascal", "ctdet")(
        _opt(jcfg, "ctdet", data_root, extra + ["--device_cache"]), "train")
    tds._image_cache_dims = ImageCache.build(tds).dims
    jds._image_cache_dims = JDC.ImageCache.build(jds).dims
    for i in range(len(tds)):
        a = host.get_sample(i, rng=np.random.RandomState(160 + i))
        b = tds.get_sample(i, rng=np.random.RandomState(160 + i))
        c = jds.get_sample(i, rng=np.random.RandomState(160 + i))
        assert "hm" in b and "hm_ct" not in b and "dense_wh" in b
        assert set(a) - {"input_u8"} == set(b) - {"img_idx", "warp_ti"}
        for k in a:
            if k != "input_u8":
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        _assert_samples_equal(c, b)


@pytest.mark.parametrize("task,extra", [
    ("ctdet", ["--mse_loss", "--dense_wh"]),
    ("ctdet", ["--mse_loss", "--dense_wh", "--device_cache"]),
    ("multi_pose", ["--mse_loss", "--dense_hp"])],
    ids=["ctdet", "ctdet_cache", "multi_pose"])
def test_rank_rows_equal_one_process(data_root, task, extra):
    """Two ranks replaying the earlier rows' draws (draw_only): each
    rank's rows of every batch bit-equal to the one-process batch; the
    MSRA splat and the dense maps draw nothing."""
    def make():
        ds = get_dataset(TASKS[task][0], task)(
            _opt(tcfg, task, data_root, extra), "train")
        if "--device_cache" in extra:
            ds._image_cache_dims = ImageCache.build(ds).dims
        return ds
    assert_rank_rows_equal(make, batch_size=2, epochs=2)


# -- losses ------------------------------------------------------------------

def _loss_case(task, extra, seed):
    opt = _opt(tcfg, task, "", extra)
    r = rng(seed)
    n, h, w, m = 2, 8, 8, 5
    outs = {k: r.randn(n, h, w, c).astype(np.float32)
            for k, c in opt.heads.items()}

    def heat(c):
        hm = (r.rand(n, h, w, c) * 0.9).astype(np.float32)
        hm[0, 2, 3, 0] = hm[1, 5, 1, c - 1] = 1.0
        return hm

    def dense(c):
        return (r.uniform(-4, 9, (n, h, w, c)).astype(np.float32),
                (r.rand(n, h, w, c) * (r.rand(n, h, w, 1) < 0.5))
                .astype(np.float32))
    batch = {"ind": r.randint(0, h * w, (n, m)).astype(np.int64),
             "reg_mask": (r.rand(n, m) < 0.7).astype(np.uint8),
             "wh": r.uniform(1, 9, (n, m, 2)).astype(np.float32),
             "reg": r.rand(n, m, 2).astype(np.float32)}
    if task == "ctdet":
        batch["hm"] = heat(opt.num_classes)
        batch["dense_wh"], batch["dense_wh_mask"] = dense(2)
    elif task == "multi_pose":
        batch.update(
            hm=heat(1), hm_hp=heat(17),
            hps=r.randn(n, m, 34).astype(np.float32),
            hps_mask=(r.rand(n, m, 34) < 0.6).astype(np.uint8),
            hp_offset=r.rand(n, m * 17, 2).astype(np.float32),
            hp_ind=r.randint(0, h * w, (n, m * 17)).astype(np.int64),
            hp_mask=(r.rand(n, m * 17) < 0.5).astype(np.int64))
        batch["dense_hps"], batch["dense_hps_mask"] = dense(34)
    elif task == "ddd":
        batch.update(hm=heat(opt.num_classes),
                     dep=r.uniform(5, 40, (n, m, 1)).astype(np.float32),
                     dim=r.uniform(1, 4, (n, m, 3)).astype(np.float32),
                     rotbin=r.randint(0, 2, (n, m, 2)).astype(np.int64),
                     rotres=r.uniform(-1, 1, (n, m, 2)).astype(np.float32),
                     rot_mask=(r.rand(n, m) < 0.7).astype(np.uint8))
    else:
        for p in "tlbr":
            batch["hm_" + p] = heat(opt.num_classes)
            batch["reg_" + p] = r.rand(n, m, 2).astype(np.float32)
            batch["ind_" + p] = r.randint(0, h * w, (n, m)).astype(np.int64)
        batch["hm_c"] = heat(opt.num_classes)
    return opt, outs, batch


@pytest.mark.parametrize("task,extra", [
    ("ctdet", ["--mse_loss"]), ("ctdet", ["--dense_wh"]),
    ("ctdet", ["--mse_loss", "--dense_wh"]),
    ("multi_pose", ["--dense_hp"]),
    ("multi_pose", ["--mse_loss", "--dense_hp"]),
    ("ddd", ["--mse_loss"]), ("exdet", ["--mse_loss"])],
    ids=["ctdet_mse", "ctdet_dense_wh", "ctdet_mse_dense_wh",
         "multi_pose_dense_hp", "multi_pose_mse_dense_hp", "ddd_mse",
         "exdet_mse"])
def test_loss_matches_jax(task, extra):
    """Loss, its parts and the gradients w.r.t. every head. Under
    --mse_loss ddd's and multi_pose's heatmap losses stay focal, as in
    the JAX package."""
    opt, outs, batch = _loss_case(task, extra, 170 + len(extra))
    jopt = _opt(jcfg, task, "", extra)

    def jfn(o):
        loss, stats = JL.LOSS_FACTORY[task](
            [o], {k: jnp.asarray(v) for k, v in batch.items()}, jopt)
        return loss, stats
    (jloss, jstats), jgrads = jax.value_and_grad(jfn, has_aux=True)(
        {k: jnp.asarray(v) for k, v in outs.items()})
    touts = {k: torch.from_numpy(v).requires_grad_()
             for k, v in outs.items()}
    loss, stats = TL.LOSS_FACTORY[task](
        [touts], {k: torch.from_numpy(v) for k, v in batch.items()},
        LossOpts(opt))
    loss.backward()
    assert set(stats) == set(jstats)
    for k in jstats:
        np.testing.assert_allclose(float(stats[k]), float(jstats[k]),
                                   rtol=2e-3, atol=1e-6, err_msg=k)
    for k, g in jgrads.items():
        g = np.asarray(g)
        got = np.zeros_like(g) if touts[k].grad is None \
            else to_np(touts[k].grad)
        scale = max(float(np.abs(g).max()), 1e-12)
        assert float(np.abs(got - g).max()) <= 5e-3 * scale, k


# -- one train step ----------------------------------------------------------

def test_mse_dense_wh_train_step_matches_jax(data_root):
    """Config a FP32 at 64² with --mse_loss --dense_wh: one Adam step from
    the conditioned init on a sampler batch, against the JAX Trainer."""
    extra = ["--mse_loss", "--dense_wh"]
    tds = get_dataset("pascal", "ctdet")(
        _opt(tcfg, "ctdet", data_root, extra), "train")
    batch = next(iter(DataLoader(tds, 2, shuffle=True, num_workers=1,
                                 seed=3)))
    assert "dense_wh" in batch and float(batch["dense_wh_mask"].sum()) > 0
    trainer = Trainer(_opt(tcfg, "ctdet", data_root, extra), device="cpu")
    trainer.init()
    raise_bn_biases(trainer.model, HEADS)
    jtr = JaxTrainer(_opt(jcfg, "ctdet", data_root, extra))
    jtr.init()
    assert_train_step_matches_jax(trainer, jtr, batch, LR)


# -- serving and the CLI ----------------------------------------------------

@pytest.mark.parametrize("task", ["ctdet", "ddd", "exdet"])
def test_detectors_ignore_mse_loss(task):
    """The ctdet, ddd and exdet detectors read no --mse_loss (nor do the
    JAX ones): the same request gives the same detections."""
    frame = rng(180).randint(0, 256, (96, 128, 3)).astype(np.uint8)
    extra = ["--K", "8"] if task == "exdet" else []
    results = []
    for flags in ([], ["--mse_loss"]):
        opt = _opt(tcfg, task, "", extra + flags)
        det = TDET.detector_factory(task)(opt, device="cpu")
        results.append(det.run(frame)["results"])
    for cls in results[0]:
        np.testing.assert_array_equal(np.asarray(results[0][cls]),
                                      np.asarray(results[1][cls]))


@pytest.mark.parametrize("task,extra", [
    ("ctdet", ["--mse_loss", "--dense_wh", "--device_cache"]),
    ("multi_pose", ["--mse_loss", "--dense_hp"]),
    ("ddd", ["--mse_loss"]), ("exdet", ["--mse_loss", "--K", "6"])],
    ids=["ctdet", "multi_pose", "ddd", "exdet"])
def test_cli_trains_on_dense_targets(data_root, capsys, task, extra):
    """`cli.main` trains one step of each task on its dense targets. The
    loss is finite exactly when the step's targets are: as in the JAX
    package (and the reference), ddd's and exdet's MSRA gaussians take
    the object's radius as their std, and an object of radius 0 draws a
    NaN centre (ROADMAP.md section 3); the step's batch is rebuilt by a
    loader like the CLI's to tell."""
    from codenet_torch.cli.main import main
    dataset, size = TASKS[task]
    exp_id = "torch_dense_" + task
    main([task, "--dataset", dataset, "--arch", "shufflenetv2", "--gpus",
          "-1", "--data_dir", data_root, "--exp_id", exp_id, "--batch_size",
          "2", "--num_epochs", "1", "--num_iters", "1", "--val_intervals",
          "-1", "--num_workers", "1", "--print_iter", "1"] + size + extra)
    out = capsys.readouterr().out
    losses = [float(ln.split(" loss ")[1].split()[0])
              for ln in out.splitlines() if ln.startswith("train epoch")]
    opt = _opt(tcfg, task, data_root, extra)
    ds = get_dataset(dataset, task)(opt, "train")
    if opt.device_cache:
        ds._image_cache_dims = ImageCache.build(ds).dims
    batch = next(iter(DataLoader(ds, 2, shuffle=True, num_workers=1,
                                 seed=opt.seed)))
    finite = all(np.isfinite(v).all() for k, v in batch.items()
                 if k != "meta" and np.asarray(v).dtype.kind == "f")
    assert len(losses) == 1 and np.isfinite(losses[0]) == finite, \
        out[-2000:]
    if task != "exdet":  # at 64² some extreme point has radius 0
        assert finite
