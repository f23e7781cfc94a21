"""Real int8 and the W4A8 artifact of every task's heads against the JAX
package: ctdet on COCO (80 classes), multi_pose (six heads), ddd (six
heads, 64x192) and exdet (nine heads), each at 64^2 but ddd.

As tests/test_torch_int8.py holds config a's VOC heads: seeded weights
with calibrated BN (perturb_variables), activation ranges from two
fake-quant update passes, the JAX int8 model jitted with its deform conv
in Pallas interpret mode (so that both sides sample in bf16), the
artifact written by both packages, and each task's detector served from
the `.pth` and from the artifact.
"""

import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_common import perturb_variables, rng, to_np
from test_torch_int8 import _assert_heads_within, _blobs

from codenet_tpu.engine import w4a8 as JW
from codenet_tpu.engine.torch_import import convert_shufflenetv2
from codenet_tpu.models import create_model as jax_create_model
from codenet_tpu.models.layers import QuantSpec as JaxQuantSpec
from codenet_torch import config as tcfg
from codenet_torch.engine import checkpoint, w4a8
from codenet_torch.engine.detector import detector_factory
from codenet_torch.engine.jax_weights import (from_jax_variables,
                                              to_jax_variables)
from codenet_torch.models import create_model
from codenet_torch.models import layers as TL
from codenet_torch.models.layers import QuantSpec

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
INT8 = QuantSpec(int8_infer=True)
# each task's CLI flags (the detector's and the export tool's), its seed
# and a raw frame (h, w) for one request
TASKS = {
    "coco_ctdet": (["ctdet", "--dataset", "coco", "--input_res", "64",
                    "--flip_test"], 140, (90, 120)),
    "multi_pose": (["multi_pose", "--dataset", "coco_hp", "--input_res",
                    "64", "--flip_test"], 141, (120, 90)),
    "ddd": (["ddd", "--dataset", "kitti", "--input_h", "64", "--input_w",
             "192"], 142, (75, 248)),
    "exdet": (["exdet", "--dataset", "coco", "--input_res", "64",
               "--flip_test", "--K", "8"], 143, (90, 120)),
}


def _args(name, *extra):
    return TASKS[name][0] + ["--arch", "shufflenetv2", "--resume-quantize",
                             "--gpus", "-1", *extra]


def _opt(name, *extra):
    opt = tcfg.parse(_args(name, *extra))
    return tcfg.update_dataset_info_and_set_heads(
        opt, tcfg.DATASET_SPECS[opt.dataset])


def _head_tol(heads):
    """tests/test_torch_int8.py's HEAD_TOL by kind: a heatmap's logits
    (max |value| mostly its -2.19 bias) 2e-2 of that max, a regression
    head 1e-1."""
    return {k: 2e-2 if k.startswith("hm") else 1e-1 for k in heads}


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope="module", params=list(TASKS))
def task(request, tmp_path_factory):
    """One task's int8 model (port) from seeded weights with calibrated BN
    and warmed ranges, the port's and the JAX package's int8 heads on an
    input batch of 2, and the artifact written by each package."""
    name = request.param
    _, seed, _ = TASKS[name]
    opt = _opt(name)
    heads = dict(opt.heads)
    hw = (opt.input_h, opt.input_w)
    base = create_model("shufflenetv2", heads, 64, device="cpu",
                        generator=torch.Generator().manual_seed(seed))
    sd = {k: v.numpy() for k, v in base.state_dict().items()}
    variables = perturb_variables(
        convert_shufflenetv2(sd, heads=tuple(sorted(heads))), seed=seed)
    x = (rng(seed).randn(2, *hw, 3) * 0.5).astype(np.float32)
    fake = create_model("shufflenetv2", heads, 64, qspec=QuantSpec(),
                        device="cpu")
    fake.load_state_dict(from_jax_variables(variables), strict=False)
    with torch.no_grad():
        for _ in range(2):
            fake(_t(x), update_stats=True)
    model = create_model("shufflenetv2", heads, 64, qspec=INT8,
                         device="cpu")
    model.load_state_dict(fake.state_dict())
    variables["quant_stats"] = to_jax_variables(
        fake.state_dict())["quant_stats"]
    with torch.no_grad():
        out = {k: to_np(v) for k, v in model(_t(x)).items()}

    jmodel = jax_create_model("shufflenetv2", heads, 64,
                              qspec=JaxQuantSpec(int8_infer=True))
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("CODENET_PALLAS_INTERPRET", "1")
        ref = jax.jit(jmodel.apply)(variables, jnp.asarray(x))

    root = tmp_path_factory.mktemp(name)
    port_path, jax_path = str(root / "port.npz"), str(root / "jax.npz")
    sizes = w4a8.export_w4a8(model, hw, port_path)
    # the JAX exporter as it runs, eagerly (jitted, XLA folds BN in
    # another order and a level at a rounding tie can flip), on a 32^2
    # capture: the integer weights do not depend on the input
    JW.export_w4a8(jmodel, variables, (32, 32), jax_path)
    return {"name": name, "opt": opt, "model": model, "heads": out,
            "jax_heads": {k: np.asarray(v) for k, v in ref.items()},
            "port": port_path, "jax": jax_path, "sizes": sizes}


def _frame(name, seed):
    h, w = TASKS[name][2]
    return rng(seed).randint(0, 256, (h, w, 3)).astype(np.uint8)


def test_int8_heads_match_jax(task):
    """Every head of the port's int8 forward within the tolerance of its
    kind (_head_tol) of the JAX package's int8 forward."""
    assert set(task["heads"]) == set(task["opt"].heads)
    _assert_heads_within(task["jax_heads"], task["heads"],
                         _head_tol(task["heads"]))


def test_artifact_bytes_equal_jax(task):
    """The same model exported by both packages: the same manifest, the
    same q_blob, f_blob and qs_blob bytes, every blob the same size, the
    scales and folded biases within 1e-6 relative (the BN fold rounds in
    each framework's order)."""
    port, pman = _blobs(task["port"])
    ref, jman = _blobs(task["jax"])
    assert pman == jman
    assert {k: v.nbytes for k, v in port.items()} == \
        {k: v.nbytes for k, v in ref.items()}
    for k in ("q_blob", "f_blob", "qs_blob"):
        np.testing.assert_array_equal(port[k], ref[k], err_msg=k)
    for k in ("s_blob", "b_blob"):
        np.testing.assert_allclose(port[k], ref[k], rtol=1e-6,
                                   atol=1e-6 * np.abs(ref[k]).max(),
                                   err_msg=k)
    assert task["sizes"]["file_bytes"] == os.path.getsize(task["port"])
    # every head's three convs are covered: the artifact ships no float
    # leaf but layer0's
    assert {tuple(f["path"][:-1]) for f in pman["floats"]} == {("layer0",)}
    covered = {tuple(c["path"]) for c in pman["convs"]}
    assert len(covered) == 3 * 16 + 2 * 3 + 1 + 3 * 3 \
        + 3 * len(task["opt"].heads)


def test_artifact_served_equals_checkpoint_served(task, tmp_path):
    """tools_torch/export_w4a8.py with the task's CLI flags writes the
    .pth's artifact blob for blob; the task's detector with
    --resume-quantize --int8_infer gives equal detections from the .pth
    (its recipe adopted, its integer weights derived once) and from the
    artifact."""
    name = task["name"]
    path = str(tmp_path / "model_last.pth")
    art = str(tmp_path / "model_w4a8.npz")
    checkpoint.save_model(path, 1, task["model"], qspec=INT8)
    spec = importlib.util.spec_from_file_location(
        "export_w4a8", os.path.join(REPO, "tools_torch", "export_w4a8.py"))
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    assert tool.main(_args(name, "--load_model", path, "--out", art)) == 0
    got, want = _blobs(art), _blobs(task["port"])
    assert got[1] == want[1]
    for k in want[0]:
        np.testing.assert_array_equal(got[0][k], want[0][k], err_msg=k)

    frame = _frame(name, TASKS[name][1] + 1)
    dets = []
    for extra in (["--load_model", path], ["--w4a8_artifact", art]):
        det = detector_factory(task["opt"].task)(
            _opt(name, "--int8_infer", *extra), device="cpu")
        assert det.qspec.int8_infer
        images, meta = det.pre_process(frame, 1)
        dets.append(to_np(det.process(images, meta["trans_inv"], 1)))
    np.testing.assert_array_equal(dets[0], dets[1])


def test_detector_int8_run(task, monkeypatch):
    """The task's detector answers one request through `run` in real int8
    from the artifact: the deform calls sample in bf16, the int8 convs
    run, and the results come in the task's format, finite."""
    name = task["name"]
    det = detector_factory(task["opt"].task)(
        _opt(name, "--int8_infer", "--w4a8_artifact", task["port"]),
        device="cpu")
    dtypes, convs = [], []
    fast, int8_conv = TL.codesign_deform_conv_fast, TL.Q.int8_conv

    def deform(xs, s, w):
        dtypes.append(xs.dtype)
        return fast(xs, s, w)

    def counted(*a):
        convs.append(a)
        return int8_conv(*a)
    monkeypatch.setattr(TL, "codesign_deform_conv_fast", deform)
    monkeypatch.setattr(TL.Q, "int8_conv", counted)
    ret = det.run(_frame(name, TASKS[name][1] + 2))
    # one forward (the flip-test pair is one batch): three deform calls,
    # and every int8 conv but the heads' (3 each) and the stem's
    assert dtypes == [torch.bfloat16] * 3
    assert len(convs) == 70 - 9 + 3 * len(task["opt"].heads)
    results = ret["results"]
    num_classes = task["opt"].num_classes
    assert list(results) == list(range(1, num_classes + 1))
    width = {"ctdet": 5, "multi_pose": 39, "ddd": 14,
             "exdet": 5}[task["opt"].task]
    for rows in results.values():
        rows = np.asarray(rows, np.float32).reshape(-1, width)
        assert np.isfinite(rows).all()
    for key in ("tot", "pre", "net", "dec", "post", "merge"):
        assert ret[key] >= 0.0
