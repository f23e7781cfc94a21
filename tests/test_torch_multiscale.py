"""Multi-scale test, soft-NMS merge and --keep_res: the port's pre-process
and detector against cv2 and the JAX package.

- `resize_u8` against cv2.resize(INTER_LINEAR): within 1 level (cv2
  interpolates uint8 in 11-bit fixed point), exact at scale 1.
- `pre_process` against the JAX detector's (cv2 resize + warpAffine) at
  scales 0.5-1.5, fix_res and keep_res: meta equal (trans_inv to 1e-6),
  images within 2 levels (two resamplings, each rounded).
- A flip-test `run` at five scales with --nms, and one with --keep_res at
  two scales, against the JAX CtdetDetector on the same weights, both fed
  the JAX pre-processed images: every merged detection within 2e-3 (f32).
"""

import numpy as np
import pytest

from test_torch_common import HEADS, perturb_variables, rng

cv2 = pytest.importorskip("cv2")

from codenet_tpu import config as jcfg
from codenet_tpu.engine.detector import CtdetDetector as JaxCtdetDetector
from codenet_tpu.engine.torch_import import convert_shufflenetv2
from codenet_torch import config as tcfg
from codenet_torch.data.affine import resize_u8
from codenet_torch.engine.detector import CtdetDetector
from codenet_torch.engine.jax_weights import from_jax_variables
from codenet_torch.models import create_model

ARGS = ["ctdet", "--dataset", "pascal", "--arch", "shufflenetv2",
        "--input_res", "64", "--flip_test"]
SCALES = [0.5, 0.75, 1.0, 1.25, 1.5]


def _opt(cfg, extra):
    return cfg.update_dataset_info_and_set_heads(
        cfg.parse(ARGS + list(extra)), cfg.DATASET_SPECS["pascal"])


def _frame(seed, h, w):
    """Noise with a few filled boxes: flat regions and sharp edges."""
    r = rng(seed)
    img = (r.rand(h, w, 3) * 80).astype(np.uint8)
    for _ in range(3):
        bh, bw = r.randint(8, h // 2), r.randint(8, w // 2)
        y, x = r.randint(0, h - bh), r.randint(0, w - bw)
        img[y:y + bh, x:x + bw] = r.randint(0, 256, 3)
    return img


@pytest.mark.parametrize("scale", SCALES)
def test_resize_u8_matches_cv2(scale):
    for h, w in ((375, 500), (500, 375)):
        img = _frame(90, h, w)
        nw, nh = int(w * scale), int(h * scale)
        out = resize_u8(img, nw, nh)
        ref = cv2.resize(img, (nw, nh))
        assert out.shape == ref.shape and out.dtype == np.uint8
        diff = np.abs(out.astype(np.int32) - ref.astype(np.int32))
        assert diff.max() <= (0 if scale == 1.0 else 1), diff.max()


@pytest.fixture(scope="module")
def weights():
    model = create_model("shufflenetv2", HEADS, 64, device="cpu")
    sd = {k: v.numpy() for k, v in model.state_dict().items()}
    return perturb_variables(convert_shufflenetv2(sd), seed=91)


def _detectors(weights, extra):
    jdet = JaxCtdetDetector(_opt(jcfg, extra), variables=weights)
    tdet = CtdetDetector(_opt(tcfg, extra),
                         state_dict=from_jax_variables(weights),
                         device="cpu")
    return jdet, tdet


@pytest.mark.parametrize("extra", [[], ["--keep_res"],
                                   ["--host_normalize"]],
                         ids=["fix_res", "keep_res", "host_normalize"])
def test_pre_process_matches_jax(weights, extra):
    jdet, tdet = _detectors(weights, extra)
    for h, w in ((75, 100), (100, 75)):
        frame = _frame(92, h, w)
        for scale in SCALES:
            ref, rmeta = jdet.pre_process(frame, scale)
            out, meta = tdet.pre_process(frame, scale)
            assert out.shape == ref.shape and out.dtype == ref.dtype
            for k in ("c", "s", "out_height", "out_width"):
                np.testing.assert_array_equal(meta[k], rmeta[k], err_msg=k)
            np.testing.assert_allclose(meta["trans_inv"], rmeta["trans_inv"],
                                       rtol=0, atol=1e-6)
            if out.dtype == np.uint8:
                diff = np.abs(out.astype(np.int32) - ref.astype(np.int32))
                assert diff.max() <= 2, (scale, diff.max())
            else:  # --host_normalize: 2 levels in normalised units
                assert np.abs(out - ref).max() <= 2 / 255 / 0.224 + 1e-5


def _merged_close(ref, out, tol=2e-3):
    assert sorted(ref) == sorted(out) == list(range(1, 21))
    for j in ref:
        assert ref[j].shape == out[j].shape, j
        np.testing.assert_allclose(out[j], ref[j], rtol=tol, atol=tol,
                                   err_msg=str(j))


@pytest.mark.parametrize("extra", [["--test_scales", "0.5,0.75,1,1.25,1.5",
                                    "--nms"],
                                   ["--test_scales", "0.5,1", "--keep_res"]],
                         ids=["multiscale_nms", "keep_res"])
def test_run_matches_jax(weights, extra):
    """One flip-test request through `run`: the port fed the JAX
    pre-processed images of every scale, the merged (soft-NMS) detections
    held against the JAX detector's."""
    jdet, tdet = _detectors(weights, extra)
    frame = _frame(93, 96, 128)
    images, meta = {}, {}
    for scale in jdet.scales:
        images[scale], meta[scale] = jdet.pre_process(frame, scale)
    pre = {"image": frame, "images": images, "meta": meta}
    ref = jdet.run(pre)["results"]
    out = tdet.run(pre)["results"]
    assert sum(len(v) for v in out.values()) > 0
    _merged_close(ref, out)
