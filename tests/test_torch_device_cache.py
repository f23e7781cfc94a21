"""The device image cache (--device_cache), the device warp
(--device_warp) and --host_normalize: the port against the JAX package.

A synthetic VOC set of six 160x120 frames, every other one cropped to
100x90, so the cache's stack is ragged (rows zero-padded):

- `flip_compose` equals the JAX one exactly, and warping the raw frame
  with it equals warping the flipped frame (1e-3 of a level);
- `ImageCache.build` (single pass and two-pass) equals the JAX one: the
  stack and the dims, exactly;
- cache-mode and --host_normalize samples equal the JAX sampler's under
  one RandomState (the host-normalised image within 1e-5: cv2's grey
  conversion against a matmul);
- `model_input` of a cache batch against the JAX `model_input` (1e-5),
  and the cache path's unrounded warp within half a level of the host
  path's uint8 pixels;
- one --device_cache train step against the JAX step (the tolerances of
  test_torch_train.py::test_train_step_matches_jax);
- `cli.main --device_cache`, then `cli.test --batch_eval 2` with the host
  warp, --device_warp and --device_cache: cached detections equal the
  device warp's (rtol 1e-5, atol 1e-4), and the device warp's match the
  host warp's for at least 97% of boxes (1 px, 0.05 score).
"""

import json
import os
import types

import numpy as np
import pytest
import torch

from test_torch_common import (HEADS, assert_train_step_matches_jax,
                               raise_bn_biases, rng)

cv2 = pytest.importorskip("cv2")

import jax.numpy as jnp

from codenet_tpu import config as jcfg
from codenet_tpu.data import device_aug as JA
from codenet_tpu.data import device_cache as JDC
from codenet_tpu.data import samplers as JS
from codenet_tpu.data.datasets import get_dataset as jax_get_dataset
from codenet_tpu.engine.trainer import Trainer as JaxTrainer
from codenet_torch import config as tcfg
from codenet_torch.data.affine import (get_affine_transform, invert_affine,
                                       warp_affine, warp_affine_batch,
                                       warp_affine_u8)
from codenet_torch.data.datasets import get_dataset
from codenet_torch.data.device_aug import model_input
from codenet_torch.data.device_cache import ImageCache, flip_compose
from codenet_torch.data.loader import DataLoader
from codenet_torch.engine.trainer import Trainer, batch_to_device

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LR = 1.25e-4
DIMS = [[120, 160], [90, 100]] * 3


@pytest.fixture(scope="module")
def voc_root(tmp_path_factory):
    from synthetic import make_voc_dataset
    root = str(tmp_path_factory.mktemp("torch_cache_voc"))
    make_voc_dataset(root, num_images=6, img_w=160, img_h=120)
    ann_dir = os.path.join(root, "voc", "annotations")
    cropped = set()
    for name in os.listdir(ann_dir):
        path = os.path.join(ann_dir, name)
        with open(path) as f:
            db = json.load(f)
        for info in db["images"]:
            if info["id"] % 2 == 0:
                info["width"], info["height"] = 100, 90
                cropped.add(info["file_name"])
        with open(path, "w") as f:
            json.dump(db, f)
    for name in cropped:
        path = os.path.join(root, "voc", "images", name)
        cv2.imwrite(path, cv2.imread(path)[:90, :100])
    return root


def _opt(cfg, voc_root, extra=()):
    args = ["ctdet", "--dataset", "pascal", "--arch", "shufflenetv2",
            "--input_res", "64", "--batch_size", "2", "--gpus", "-1",
            "--data_dir", voc_root] + list(extra)
    return cfg.update_dataset_info_and_set_heads(
        cfg.parse(args), cfg.DATASET_SPECS["pascal"])


def _datasets(voc_root, extra=(), split="train"):
    return (jax_get_dataset("pascal", "ctdet")(_opt(jcfg, voc_root, extra),
                                               split),
            get_dataset("pascal", "ctdet")(_opt(tcfg, voc_root, extra),
                                           split))


def _cached(voc_root, extra=()):
    """(JAX dataset, port dataset, port cache) in cache mode."""
    jds, tds = _datasets(voc_root, ("--device_cache",) + tuple(extra))
    cache = ImageCache.build(tds)
    jds._image_cache_dims = JDC.ImageCache.build(jds).dims
    tds._image_cache_dims = cache.dims
    return jds, tds, cache


def test_flip_compose_matches_jax():
    img = rng(100).randint(0, 256, (48, 72, 3)).astype(np.uint8)
    c = np.array([41.0, 20.0], np.float32)  # the flipped frame's centre
    ti_f = get_affine_transform(c, 60.0, 0, [64, 64], inv=1)
    out = flip_compose(ti_f, 72)
    np.testing.assert_array_equal(out, JDC.flip_compose(ti_f, 72))
    want = warp_affine(torch.from_numpy(img[:, ::-1].copy()), ti_f, 64, 64)
    got = warp_affine(torch.from_numpy(img), out, 64, 64)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=1e-3)


def test_image_cache_build_matches_jax(voc_root):
    jds, tds = _datasets(voc_root)
    ref = JDC.ImageCache.build(jds)
    for out in (ImageCache.build(tds), ImageCache._build_two_pass(tds)):
        assert out.images.shape == (6, 120, 160, 3)
        assert out.dims.tolist() == DIMS
        np.testing.assert_array_equal(out.images, ref.images)
        np.testing.assert_array_equal(out.dims, ref.dims)
    cache = ImageCache.build(tds)
    dev = cache.to_device("cpu")
    assert cache.images is None and cache.nbytes == 6 * 120 * 160 * 3
    assert torch.equal(dev, torch.from_numpy(ref.images))
    # --device_cache_shard in one process: its one shard holds every row,
    # as the JAX cache's over a one-device mesh
    import jax
    from codenet_tpu.parallel import get_mesh
    jcache = JDC.ImageCache.build(jds)
    jdev = jcache.to_device(get_mesh(jax.devices()[:1]), shard=True)
    cache = ImageCache.build(tds)
    dev = cache.to_device("cpu", shard=True)
    assert (cache.shard_rows, cache.shard_ranges) == (
        jcache.shard_rows, jcache.shard_ranges) == (6, [(0, 6)])
    assert torch.equal(dev, torch.from_numpy(np.asarray(jdev)))


def _port_warp_in_jax_sampler(monkeypatch):
    """Give the JAX sampler the port's warp in place of cv2.warpAffine."""
    real = JS.cv2

    def warp(img, trans, size, flags=None):
        return warp_affine_u8(img, invert_affine(trans), size[1], size[0])

    monkeypatch.setattr(JS, "cv2", types.SimpleNamespace(
        imread=real.imread, warpAffine=warp, INTER_LINEAR=real.INTER_LINEAR))


@pytest.mark.parametrize("mode", ["device_cache", "host_normalize"])
def test_samples_match_jax(voc_root, monkeypatch, mode):
    """Same RandomState, same sample: crop, flip, colour-aug draws and
    every target; in cache mode the row and the warp matrix (flip folded
    in), with --host_normalize the host-augmented image and the dense
    heatmap."""
    if mode == "device_cache":
        jds, tds, _ = _cached(voc_root)
    else:
        _port_warp_in_jax_sampler(monkeypatch)
        jds, tds = _datasets(voc_root, ["--host_normalize"])
    flips = 0
    for i in range(len(tds)):
        a = jds.get_sample(i, rng=np.random.RandomState(110 + i))
        b = tds.get_sample(i, rng=np.random.RandomState(110 + i))
        assert set(a) == set(b)
        for k in a:
            if k == "input":
                assert b[k].dtype == np.float32
                np.testing.assert_allclose(b[k], a[k], rtol=0, atol=1e-5)
                continue
            assert np.asarray(a[k]).dtype == np.asarray(b[k]).dtype, k
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        if mode == "device_cache":
            assert int(b["img_idx"]) == i and "input_u8" not in b
            flips += b["warp_ti"][0, 0] < 0
        else:
            assert "hm" in b and "hm_ct" not in b
    if mode == "device_cache":
        assert 0 < flips < len(tds)
        # the cache path needs the device input path
        tds.opt.host_normalize = True
        with pytest.raises(ValueError):
            tds.get_sample(0, rng=np.random.RandomState(0))


def test_model_input_of_a_cache_batch_matches_jax(voc_root):
    """Gather, warp (f32, not rounded), /255, colour aug and normalise of
    a batch of three cache samples: port against JAX within 1e-5."""
    _, tds, cache = _cached(voc_root)
    stack = cache.images.copy()
    batch = next(iter(DataLoader(tds, 3, shuffle=True, num_workers=1,
                                 seed=5)))
    assert batch["img_idx"].dtype == np.int32
    assert batch["warp_ti"].shape == (3, 2, 3)
    mean, std = tds.mean, tds.std
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    jbatch["cache_images"] = jnp.asarray(stack)
    ref = np.asarray(JA.model_input(jbatch, mean, std, out_hw=(64, 64)))
    out = model_input(batch_to_device(batch, "cpu"), mean, std, (64, 64),
                      cache.to_device("cpu"))
    assert out.shape == (3, 64, 64, 3)
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-5, atol=1e-5)


def test_cache_warp_within_half_a_level_of_host_path(voc_root):
    """--no_color_aug, one RandomState: the same targets from both paths;
    the cache path's warped pixels (f32, before the /255) lie within half
    a level (and f32 rounding) of the host path's rounded uint8 ones."""
    _, host = _datasets(voc_root, ["--no_color_aug"])
    _, tds, cache = _cached(voc_root, ["--no_color_aug"])
    stack = cache.to_device("cpu")
    for i in range(len(tds)):
        a = host.get_sample(i, rng=np.random.RandomState(120 + i))
        b = tds.get_sample(i, rng=np.random.RandomState(120 + i))
        for k in a:
            if k != "input_u8":
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        warped = warp_affine_batch(stack, b["warp_ti"][None], 64, 64,
                                   rows=[b["img_idx"]])[0]
        err = np.abs(warped.numpy() - a["input_u8"].astype(np.float32))
        assert err.max() <= 0.5 + 1e-3, (i, err.max())


def test_device_cache_train_step_matches_jax(voc_root):
    """One Adam step from the conditioned init on a batch of two cache
    samples: the port's step warps the rows of the stack on the device,
    the JAX step its own; loss, gradients, parameters and BN statistics
    held as in test_torch_train.py::test_train_step_matches_jax."""
    _, tds, cache = _cached(voc_root)
    stack = cache.images.copy()
    batch = next(iter(DataLoader(tds, 2, shuffle=True, num_workers=1,
                                 seed=3)))
    assert "img_idx" in batch and int(batch["reg_mask"].sum()) >= 1
    trainer = Trainer(_opt(tcfg, voc_root, ["--device_cache"]), device="cpu")
    trainer.init()
    raise_bn_biases(trainer.model, HEADS)
    jtr = JaxTrainer(_opt(jcfg, voc_root, ["--device_cache"]))
    jtr.init()
    assert_train_step_matches_jax(trainer, jtr, batch, LR, cache=stack)


def _results(exp_id):
    with open(os.path.join(REPO, "exp", "ctdet", exp_id,
                           "results.json")) as f:
        return json.load(f)


def test_cli_device_cache_train_and_batched_eval(voc_root, capsys):
    """cli.main --device_cache trains and evaluates; cli.test --batch_eval
    2 scores its checkpoint with the host warp, --device_warp and
    --device_cache."""
    from codenet_torch.cli.main import main as train_main
    from codenet_torch.cli.test import main as test_main
    common = ["ctdet", "--dataset", "pascal", "--arch", "shufflenetv2",
              "--input_res", "64", "--gpus", "-1", "--data_dir", voc_root,
              "--num_workers", "2"]
    train_main(common + ["--exp_id", "torch_devcache", "--device_cache",
                         "--batch_size", "2", "--num_epochs", "1",
                         "--num_iters", "2", "--val_intervals", "-1",
                         "--print_iter", "1"])
    out = capsys.readouterr().out
    assert "device_cache: 6 images, 0.3 MB -> cpu" in out
    assert len([ln for ln in out.splitlines()
                if ln.startswith("train epoch")]) == 2
    assert "Mean AP" in out
    ckpt = os.path.join(REPO, "exp", "ctdet", "torch_devcache",
                        "model_last.pth")
    res = {}
    for name, extra in (("host", []), ("warp", ["--device_warp"]),
                        ("cache", ["--device_cache"])):
        test_main(common + ["--exp_id", "torch_devcache_" + name,
                            "--batch_eval", "2", "--flip_test",
                            "--load_model", ckpt] + extra)
        res[name] = _results("torch_devcache_" + name)
    out = capsys.readouterr().out
    assert ("device_warp: 0 of 6 frames larger than the 128x192 buffer "
            "took the host warp") in out
    matched = total = 0
    for cls in range(1, 21):
        for h, w, c in zip(res["host"][cls], res["warp"][cls],
                           res["cache"][cls]):
            h, w, c = (np.asarray(d, np.float32).reshape(-1, 5)
                       for d in (h, w, c))
            assert h.shape == w.shape == c.shape, cls
            np.testing.assert_allclose(c, w, rtol=1e-5, atol=1e-4)
            total += len(h)
            close = (np.abs(h[:, :4] - w[:, :4]).max(axis=1) <= 1.0) \
                & (np.abs(h[:, 4] - w[:, 4]) <= 0.05)
            matched += int(close.sum())
    assert total > 0 and matched / total >= 0.97, (matched, total)
