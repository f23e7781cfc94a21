"""The port's ctdet serving path against the JAX package, and its CLI.

Both detectors get the same carried weights (the port's init, perturbed
with numpy) and the same pre-warped uint8 batch at --input_res 64 with
--flip_test; `process`, `process_batch` and `merge_outputs` must agree:
classes exactly, scores within 1e-4, boxes within 1e-2 px.
"""

import json
import os
import subprocess
import sys

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from test_torch_common import HEADS, perturb_variables, rng, to_np

from codenet_tpu import config as jcfg
from codenet_tpu.data.affine import warp_affine_jax
from codenet_tpu.engine.detector import CtdetDetector as JaxCtdetDetector
from codenet_tpu.engine.torch_import import convert_shufflenetv2
from codenet_torch import config as tcfg
from codenet_torch.data.affine import get_affine_transform, warp_affine
from codenet_torch.engine.detector import CtdetDetector
from codenet_torch.engine.jax_weights import from_jax_variables
from codenet_torch.models import create_model

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARGS = ["ctdet", "--dataset", "pascal", "--arch", "shufflenetv2",
        "--input_res", "64", "--flip_test"]


def _opt(cfg, args):
    return cfg.update_dataset_info_and_set_heads(
        cfg.parse(args), cfg.DATASET_SPECS["pascal"])


@pytest.fixture(scope="module")
def detectors():
    model = create_model("shufflenetv2", HEADS, 64, device="cpu")
    sd = {k: v.numpy() for k, v in model.state_dict().items()}
    variables = perturb_variables(convert_shufflenetv2(sd), seed=20)
    jdet = JaxCtdetDetector(_opt(jcfg, ARGS), variables=variables)
    tdet = CtdetDetector(_opt(tcfg, ARGS),
                         state_dict=from_jax_variables(variables),
                         device="cpu")
    return jdet, tdet


def _frames(seed, b):
    """b pre-warped 64^2 uint8 frames laid out [originals; flipped], and
    the output->original affines of VOC-sized 500x375 / 375x500 frames."""
    img = rng(seed).randint(0, 256, (b, 64, 64, 3)).astype(np.uint8)
    images = np.concatenate([img, img[:, :, ::-1]], axis=0)
    tis = []
    for i in range(b):
        w, h = (500, 375) if i % 2 == 0 else (375, 500)
        c = np.array([w / 2.0, h / 2.0], np.float32)
        tis.append(get_affine_transform(c, max(w, h) * 1.0, 0, [16, 16],
                                        inv=1).astype(np.float32))
    return images, np.stack(tis)


def _assert_dets_close(ref, out):
    ref = np.asarray(ref, np.float32)
    out = np.asarray(out, np.float32)
    assert ref.shape == out.shape
    np.testing.assert_array_equal(out[..., 5], ref[..., 5])
    np.testing.assert_allclose(out[..., 4], ref[..., 4], rtol=0, atol=1e-4)
    np.testing.assert_allclose(out[..., :4], ref[..., :4], rtol=0,
                               atol=1e-2)


def test_process_matches_jax(detectors):
    jdet, tdet = detectors
    images, tis = _frames(21, 1)
    ref = jdet.process(images, tis[0], 1.0)
    out = tdet.process(images, tis[0], 1.0)
    assert out.shape == (1, 100, 6)
    _assert_dets_close(ref, to_np(out))


def test_process_batch_matches_jax(detectors):
    jdet, tdet = detectors
    images, tis = _frames(22, 3)
    ref = jdet.process_batch(images, tis)
    out = tdet.process_batch(images, tis)
    assert out.shape == (3, 100, 6)
    _assert_dets_close(ref, to_np(out))


def test_merge_outputs_matches_jax(detectors):
    jdet, tdet = detectors
    images, tis = _frames(23, 1)
    ref = jdet.merge_outputs([jdet.post_process(
        np.asarray(jdet.process(images, tis[0], 1.0)), None)])
    out = tdet.merge_outputs([tdet.post_process(
        to_np(tdet.process(images, tis[0], 1.0)), None)])
    assert sorted(ref) == sorted(out) == list(range(1, 21))
    for j in ref:
        assert ref[j].shape == out[j].shape, j
        np.testing.assert_allclose(out[j][:, 4], ref[j][:, 4], atol=1e-4)
        np.testing.assert_allclose(out[j][:, :4], ref[j][:, :4], atol=1e-2)


def test_run_timers_and_results(detectors):
    _, tdet = detectors
    frame = rng(24).randint(0, 256, (90, 120, 3)).astype(np.uint8)
    ret = tdet.run(frame)
    for key in ("tot", "load", "pre", "net", "dec", "post", "merge"):
        assert ret[key] >= 0.0, key
    n = sum(len(v) for v in ret["results"].values())
    assert 0 < n <= 100


def test_pre_process_letterbox(detectors):
    _, tdet = detectors
    frame = rng(25).randint(0, 256, (90, 120, 3)).astype(np.uint8)
    images, meta = tdet.pre_process(frame, 1)
    assert images.dtype == np.uint8 and images.shape == (2, 64, 64, 3)
    np.testing.assert_array_equal(images[1], images[0][:, ::-1])
    assert (meta["out_height"], meta["out_width"]) == (16, 16)
    # letterbox: the rows above and below the 120x90 frame stay black
    assert images[0, :4].max() == 0 and images[0, -4:].max() == 0
    # scale 0.5: the frame resized to 60x45, letterboxed into the same
    # 64x64 input with the scale-1 extent (s = 120), so it fills the
    # middle half and the border stays black
    half, hmeta = tdet.pre_process(frame, 0.5)
    assert half.dtype == np.uint8 and half.shape == (2, 64, 64, 3)
    np.testing.assert_array_equal(half[1], half[0][:, ::-1])
    assert half[0, :, :14].max() == 0 and half[0, :, -14:].max() == 0
    assert half[0, 20:44, 20:44].max() > 0
    np.testing.assert_array_equal(hmeta["c"], [30.0, 22.5])
    assert hmeta["s"] == 120.0
    np.testing.assert_allclose(hmeta["trans_inv"], meta["trans_inv"]
                               - [[0, 0, 30], [0, 0, 22.5]], atol=1e-5)


SERVED_OPTIONS = (["--nms"], ["--test_scales", "0.5,1"], ["--keep_res"],
                  ["--dtype", "bfloat16"], ["--device_cache_shard"])


@pytest.mark.parametrize("extra", [["--nms"], ["--test_scales", "0.5,1"],
                                   ["--keep_res"],
                                   ["--dtype", "bfloat16"],
                                   ["--device_cache_shard"]])
def test_unserved_options_raise(extra, detectors):
    """Options the detector does not serve raise. The cases of options
    served since (SERVED_OPTIONS: the bf16 model, and the sharded image
    cache, which shards the train cache only) keep their ids and check
    instead that one request runs: every scale
    through the network, --keep_res at the frame's own size rounded up to
    a multiple of 32, and finite merged detections (the carried weights
    of `detectors`: the init's tied scores would keep more than 100)."""
    if extra not in SERVED_OPTIONS:
        with pytest.raises(NotImplementedError):
            CtdetDetector(_opt(tcfg, ARGS + extra), device="cpu")
        return
    det = CtdetDetector(_opt(tcfg, ARGS + extra),
                        state_dict=detectors[1].model.state_dict(),
                        device="cpu")
    frame = rng(27).randint(0, 256, (90, 120, 3)).astype(np.uint8)
    shapes = []
    process = det.process

    def spy(images, *args, **kw):
        shapes.append(images.shape)
        return process(images, *args, **kw)
    det.process = spy
    ret = det.run(frame)
    scales = [0.5, 1.0] if "--test_scales" in extra else [1.0]
    if "--keep_res" in extra:
        assert shapes == [(2, 96, 128, 3)]
    else:
        assert shapes == [(2, 64, 64, 3)] * len(scales)
    dets = np.concatenate([v for v in ret["results"].values()])
    assert 0 < len(dets) <= 100 and np.isfinite(dets).all()


def test_warp_affine_matches_jax():
    r = rng(26)
    image = r.randint(0, 256, (75, 100, 3)).astype(np.float32)
    c = np.array([50.0, 37.5], np.float32)
    ti = get_affine_transform(c, 100.0, 0, [64, 64], inv=1).astype(
        np.float32)
    ref = np.asarray(warp_affine_jax(jnp.asarray(image), jnp.asarray(ti),
                                     64, 64))
    out = warp_affine(torch.from_numpy(image), ti, 64, 64)
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-5, atol=1e-3)


@pytest.fixture(scope="module")
def voc_root(tmp_path_factory):
    from synthetic import make_voc_dataset
    root = tmp_path_factory.mktemp("torch_voc")
    make_voc_dataset(str(root), num_images=3, img_w=120, img_h=90)
    return str(root)


def _results(exp_id):
    with open(os.path.join(REPO, "exp", "ctdet", exp_id,
                           "results.json")) as f:
        return json.load(f)


def test_cli_writes_results_and_map(voc_root):
    """python -m codenet_torch.cli.test on the CPU (--gpus -1)."""
    cmd = [sys.executable, "-m", "codenet_torch.cli.test", "ctdet",
           "--dataset", "pascal", "--arch", "shufflenetv2", "--input_res",
           "64", "--gpus", "-1", "--data_dir", voc_root, "--exp_id",
           "torch_cli"]
    proc = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "Mean AP" in proc.stdout
    res = _results("torch_cli")
    assert len(res) == 21 and all(len(r) == 3 for r in res)


def test_cli_batched_matches_per_image(voc_root):
    from codenet_torch.cli.test import main
    common = ["ctdet", "--dataset", "pascal", "--arch", "shufflenetv2",
              "--input_res", "64", "--gpus", "-1", "--flip_test",
              "--num_workers", "2", "--data_dir", voc_root]
    main(common + ["--exp_id", "torch_cli_img", "--not_prefetch_test"])
    main(common + ["--exp_id", "torch_cli_batch", "--batch_eval", "2"])
    ra, rb = _results("torch_cli_img"), _results("torch_cli_batch")
    for cls in range(1, 21):
        for da, db in zip(ra[cls], rb[cls]):
            da = np.asarray(da, np.float32).reshape(-1, 5)
            db = np.asarray(db, np.float32).reshape(-1, 5)
            assert da.shape == db.shape, cls
            np.testing.assert_allclose(da, db, rtol=1e-4, atol=1e-3)
