"""The port's real-int8 eval and W4A8 artifact against the JAX package.

Held against the JAX functions on seeded numpy inputs: the int8 quantizers
and `int8_conv`, the act-clamp fake-quant identity, int4 packing, the full
ShuffleNetV2-DCN 1x int8 model at 64^2 (JAX in Pallas interpret mode, so
that both sides sample the deform conv in bf16), and the artifact written
and read by either package. The models start from the port's seeded init
with calibrated BN (perturb_variables) and activation ranges warmed by two
`update_stats` passes; each is built once for the module.
"""

import json
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from test_torch_common import (HEADS, hwio_to_oihw, nchw_to_nhwc,
                               nhwc_to_nchw, perturb_variables, rng, to_np)

from codenet_tpu.engine import w4a8 as JW
from codenet_tpu.engine.torch_import import convert_shufflenetv2
from codenet_tpu.models import create_model as jax_create_model
from codenet_tpu.models import layers as JL
from codenet_tpu.models.layers import QuantSpec as JaxQuantSpec
from codenet_tpu.ops import quant as JQ
from codenet_torch import config as tcfg
from codenet_torch.engine import checkpoint, w4a8
from codenet_torch.engine.detector import CtdetDetector
from codenet_torch.engine.jax_weights import (from_jax_variables,
                                              to_jax_variables)
from codenet_torch.models import create_model
from codenet_torch.models import layers as TL
from codenet_torch.models.layers import QuantSpec
from codenet_torch.ops import quant as TQ

INT8 = QuantSpec(int8_infer=True)
# int8 heads against a model that samples the deform conv otherwise (f32,
# or bf16 with the Pallas kernel's bf16 corner weights): each head within
# this fraction of its max |value|. Either difference requantizes 2-3% of
# deform_act's levels one step the other way, and this random network
# passes a flipped level on through ~20 more quantizers: measured over
# four seeds and input scales, hm (its max |value| mostly the -2.19 bias)
# moves by 0.4-0.5%, reg and wh (max |value| ~0.5) by 4-7%.
HEAD_TOL = {"hm": 2e-2, "reg": 1e-1, "wh": 1e-1}
# the same with the int8 model sampling in f32: only the integer convs
# differ from the act-clamp fake-quant (measured: at most 2.6e-3)
F32_TOL = 2e-2


def _t(a):
    return torch.from_numpy(np.array(a))


def _int8_model(sd=None, maxpool=False, seed=0):
    model = create_model("shufflenetv2", HEADS, 64, maxpool=maxpool,
                         qspec=INT8, device="cpu",
                         generator=torch.Generator().manual_seed(seed))
    if sd is not None:
        model.load_state_dict(sd)
    return model


@pytest.fixture(scope="module")
def models():
    """Seeded weights with calibrated BN, ranges from two fake-quant
    update passes on the input; the port's int8 model, its JAX variables
    (params and batch_stats through the JAX package's own converter), the
    input and the port's int8 heads."""
    base = create_model("shufflenetv2", HEADS, 64, device="cpu")
    sd = {k: v.numpy() for k, v in base.state_dict().items()}
    variables = perturb_variables(convert_shufflenetv2(sd), seed=80)
    x = (rng(81).randn(2, 64, 64, 3) * 0.5).astype(np.float32)
    fake = create_model("shufflenetv2", HEADS, 64, qspec=QuantSpec(),
                        device="cpu")
    fake.load_state_dict(from_jax_variables(variables), strict=False)
    with torch.no_grad():
        for _ in range(2):
            fake(_t(x), update_stats=True)
    model = _int8_model(fake.state_dict())
    variables["quant_stats"] = to_jax_variables(
        fake.state_dict())["quant_stats"]
    with torch.no_grad():
        heads = {k: to_np(v) for k, v in model(_t(x)).items()}
    return {"model": model, "fake": fake, "variables": variables, "x": x,
            "heads": heads}


def _assert_heads_within(ref, out, tol):
    """Each head's max |difference| within tol[head] (or tol) of its max
    |value|; the message names the worst head against its bound."""
    tol = tol if isinstance(tol, dict) else dict.fromkeys(ref, tol)
    errs = {k: float(np.abs(ref[k] - out[k]).max())
            / float(np.abs(ref[k]).max()) for k in ref}
    worst = max(errs, key=lambda k: errs[k] / tol[k])
    assert all(errs[k] <= tol[k] for k in ref), \
        "worst head {}: {:.3g} of its max |value| (tol {}); all: {}".format(
            worst, errs[worst], tol[worst], errs)


# -- quantizers and the int8 conv ---------------------------------------------

def test_quantize_act_int8_matches_jax():
    """Equal levels, scale and zero point; XLA may fuse scale * x - zp
    into one multiply-add, which rounds a tie the other way: at most 2 of
    the 20,000 levels may differ, by one."""
    r = rng(82)
    x = (r.randn(4, 50, 100) * 2).astype(np.float32)
    lo, hi = np.array([-1.7], np.float32), np.array([2.9], np.float32)
    ref = JQ.quantize_act_int8(jnp.asarray(x), 8, jnp.asarray(lo),
                               jnp.asarray(hi))
    out = TQ.quantize_act_int8(_t(x), 8, _t(lo), _t(hi))
    assert out.values.dtype == torch.int8
    np.testing.assert_array_equal(out.scale.numpy(), np.asarray(ref.scale))
    np.testing.assert_array_equal(out.zero_point.numpy(),
                                  np.asarray(ref.zero_point))
    diff = out.values.numpy().astype(np.int32) - np.asarray(ref.values)
    assert np.abs(diff).max() <= 1 and np.count_nonzero(diff) <= 2
    # the clamp is hit: the window's both ends are stored
    assert out.values.min() == -128 and out.values.max() == 127


@pytest.mark.parametrize("shape", [(3, 3, 1, 64), (1, 1, 58, 29),
                                   (3, 3, 8, 12)])
@pytest.mark.parametrize("percentile", [False, True])
def test_quantize_weight_int_matches_jax(shape, percentile):
    """Equal 4-bit levels and scales (the multiply is the fake-quant's,
    so no tie may differ)."""
    w = rng(83).randn(*shape).astype(np.float32)
    q_ref, s_ref = JQ.quantize_weight_int(jnp.asarray(w), 4,
                                          percentile=percentile)
    q, s = TQ.quantize_weight_int(_t(hwio_to_oihw(w)), 4, percentile)
    assert q.dtype == torch.int8
    np.testing.assert_array_equal(q.numpy(), hwio_to_oihw(np.asarray(q_ref)))
    np.testing.assert_array_equal(s.numpy(), np.asarray(s_ref))


# (kernel, Cin, Cout, stride, groups): the config-a kinds of int8 conv
CONV_CASES = [(1, 58, 29, 1, 1), (3, 32, 32, 1, 32), (3, 32, 32, 2, 32),
              (1, 64, 1, 1, 1)]


@pytest.mark.parametrize("case", CONV_CASES)
@pytest.mark.parametrize("with_bias", [False, True])
def test_int8_conv_matches_jax(case, with_bias):
    """The integer accumulator equal to the JAX int32 one, and the
    requantized output within 1e-6 of its max |value|."""
    k, cin, cout, stride, groups = case
    r = rng(84)
    x = r.randn(2, 9, 11, cin).astype(np.float32)
    w = (r.randn(k, k, cin // groups, cout) * 0.3).astype(np.float32)
    bias = r.randn(cout).astype(np.float32) if with_bias else None
    lo, hi = np.array([x.min()]), np.array([x.max()])
    pad = (k - 1) // 2
    qx = JQ.quantize_act_int8(jnp.asarray(x), 8, jnp.asarray(lo, jnp.float32),
                              jnp.asarray(hi, jnp.float32))
    q_w, w_scale = JQ.quantize_weight_int(jnp.asarray(w), 4)
    ref = np.asarray(JQ.int8_conv(
        qx, q_w, w_scale, None if bias is None else jnp.asarray(bias),
        stride, pad, groups))
    acc_ref = np.asarray(jax.lax.conv_general_dilated(
        qx.values, q_w, (stride, stride), ((pad, pad), (pad, pad)),
        dimension_numbers=("NHWC", "HWIO", "NHWC"),
        feature_group_count=groups, preferred_element_type=jnp.int32))

    tqx = TQ.QTensor(_t(nhwc_to_nchw(np.asarray(qx.values))),
                     _t(np.asarray(qx.scale)), _t(np.asarray(qx.zero_point)))
    tq_w = _t(hwio_to_oihw(np.asarray(q_w)))
    acc, _ = TQ.int8_conv_terms(tqx.values, tq_w, stride, pad, groups)
    np.testing.assert_array_equal(nchw_to_nhwc(acc.numpy()),
                                  acc_ref.astype(np.float32))
    out = TQ.int8_conv(tqx, tq_w, _t(np.asarray(w_scale)),
                       None if bias is None else _t(bias), stride, pad,
                       groups)
    out = nchw_to_nhwc(out.numpy())
    assert out.shape == ref.shape
    assert np.abs(out - ref).max() <= 1e-6 * np.abs(ref).max()


def test_act_clamp_fake_quant_equals_int8_dequant():
    """act_clamp fake-quant is the int8 storage, out-of-range values
    included (the JAX test_act_clamp_fake_matches_int8_exactly): its
    quantizer bit for bit, and within 1e-6 through the straight-through
    form x + (q(x) - x), which rounds once more."""
    x = _t((rng(85).randn(256) * 4).astype(np.float32))
    lo, hi = torch.tensor([-1.5]), torch.tensor([2.5])
    qt = TQ.quantize_act_int8(x, 8, lo, hi)
    np.testing.assert_array_equal(TQ._asymmetric(x, 8, lo, hi, True).numpy(),
                                  qt.dequant().numpy())
    clamped = TQ.fake_quant_act(x, 8, lo, hi, clamp=True)
    np.testing.assert_allclose(clamped.numpy(), qt.dequant().numpy(),
                               rtol=1e-6, atol=1e-6)
    unclamped = TQ.fake_quant_act(x, 8, lo, hi, clamp=False)
    assert int(((unclamped - clamped).abs() > 1e-6).sum()) > 10


def test_pack_int4_round_trip_and_jax_bytes():
    q = rng(86).randint(-8, 8, size=(3, 3, 7, 5)).astype(np.int8)
    packed = w4a8.pack_int4(q)
    assert packed.dtype == np.uint8 and packed.nbytes == (q.size + 1) // 2
    np.testing.assert_array_equal(packed, JW.pack_int4(q))
    np.testing.assert_array_equal(w4a8.unpack_int4(packed, q.shape), q)


def test_int8_spatial_ops_match_jax():
    """The stem max pool and the 2x upsample on int8 values equal the JAX
    package's int8 max_pool (iinfo.min padding) and upsample."""
    v = rng(87).randint(-128, 128, (2, 9, 7, 6)).astype(np.int8)
    qt = TQ.QTensor(_t(nhwc_to_nchw(v)).contiguous(
        memory_format=torch.channels_last), torch.ones(1), torch.zeros(1))
    pool = TL.qt_module(torch.nn.MaxPool2d(3, 2, 1), qt)
    up = TL.qt_module(torch.nn.Upsample(scale_factor=2, mode="nearest"), qt)
    assert pool.values.dtype == up.values.dtype == torch.int8
    np.testing.assert_array_equal(nchw_to_nhwc(pool.values.numpy()),
                                  np.asarray(JL.max_pool(jnp.asarray(v))))
    np.testing.assert_array_equal(
        nchw_to_nhwc(up.values.numpy()),
        np.asarray(JL.upsample_nearest_2x(jnp.asarray(v))))


# -- the int8 model --------------------------------------------------------------

def test_int8_model_matches_jax_int8(models, monkeypatch):
    monkeypatch.setenv("CODENET_PALLAS_INTERPRET", "1")
    jmodel = jax_create_model("shufflenetv2", HEADS, 64,
                              qspec=JaxQuantSpec(int8_infer=True))
    ref = jax.jit(jmodel.apply)(models["variables"],
                                jnp.asarray(models["x"]))
    _assert_heads_within({k: np.asarray(v) for k, v in ref.items()},
                         models["heads"], HEAD_TOL)


def test_int8_model_close_to_act_clamp_fake_quant(models, monkeypatch):
    """The int8 forward against the act-clamp fake-quant forward of the
    same weights and ranges (f32 convs, f32 deform sampling): within
    HEAD_TOL as served (bf16 sampling), and within F32_TOL with the int8
    model's deform calls kept in f32, where only the integer convs
    differ. (Sampling the bf16-rounded input in f32 moves wh by 7.8%: it
    is the rounding of the input to bf16 that flips levels.)"""
    fake = create_model("shufflenetv2", HEADS, 64,
                        qspec=QuantSpec(act_clamp=True), device="cpu")
    fake.load_state_dict(models["fake"].state_dict())
    x = _t(models["x"])
    with torch.no_grad():
        ref = {k: to_np(v) for k, v in fake(x).items()}
    _assert_heads_within(ref, models["heads"], HEAD_TOL)

    dtypes = []
    fast = TL.codesign_deform_conv_fast

    def deform(xs, s, w):
        dtypes.append((xs.dtype, w.dtype))
        return fast(xs, s, w)
    monkeypatch.setattr(TL, "codesign_deform_conv_fast", deform)
    monkeypatch.setattr(TL, "INT8_SAMPLE_DTYPE", torch.float32)
    with torch.no_grad():
        out = {k: to_np(v) for k, v in models["model"](x).items()}
    assert dtypes == [(torch.float32, torch.float32)] * 3
    _assert_heads_within(ref, out, F32_TOL)


def test_int8_state_dict_keys_and_update_refused(models):
    """int8 eval changes no state_dict key (its integer weights are never
    in it) and refuses to move the frozen ranges."""
    assert set(models["model"].state_dict()) == \
        set(models["fake"].state_dict())
    with pytest.raises(ValueError, match="frozen"):
        with torch.no_grad():
            models["model"](_t(models["x"]), update_stats=True)


def test_int8_maxpool_runs():
    """--maxpool --int8_infer: the stem pool runs on int8 values (the JAX
    test_int8_maxpool_config_b_geometry)."""
    model = _int8_model(maxpool=True)
    with torch.no_grad():
        for name, buf in model.named_buffers():
            if name.endswith("x_min"):
                buf.fill_(-4.0)
            elif name.endswith("x_max"):
                buf.fill_(4.0)
        out = model(torch.zeros(1, 64, 64, 3))
    assert out["hm"].shape == (1, 16, 16, 20)
    assert torch.isfinite(out["hm"]).all()


# -- the W4A8 artifact -----------------------------------------------------------

@pytest.fixture(scope="module")
def artifacts(models, tmp_path_factory):
    """The same model exported by the port and by the JAX package."""
    root = tmp_path_factory.mktemp("w4a8")
    port_path, jax_path = str(root / "port.npz"), str(root / "jax.npz")
    sizes = w4a8.export_w4a8(models["model"], (64, 64), port_path)
    jmodel = jax_create_model("shufflenetv2", HEADS, 64,
                              qspec=JaxQuantSpec(int8_infer=True))

    def capture_jit(model, variables, input_hw):
        """JW.capture_deploy's apply, compiled (eager, it takes ~50 s)."""
        _, mut = jax.jit(lambda v, x: model.apply(
            v, x, train=False, mutable=["deploy"]))(
            variables, jnp.zeros((1,) + tuple(input_hw) + (3,)))
        return jax.device_get(dict(mut["deploy"]))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JW, "capture_deploy", capture_jit)
        JW.export_w4a8(jmodel, models["variables"], (64, 64), jax_path)
    return {"port": port_path, "jax": jax_path, "sizes": sizes}


def _blobs(path):
    with np.load(path) as z:
        arrays = {k: z[k] for k in z.files}
    manifest = json.loads(bytes(arrays.pop("manifest").tobytes()).decode())
    return arrays, manifest


def test_artifact_bit_identical_to_checkpoint_eval(models, artifacts):
    """Port export -> port load into a differently seeded template gives
    the checkpoint eval's heads bit for bit; zeroing every covered weight
    of the template changes nothing. Config a ships only layer0's float
    leaves."""
    sizes = artifacts["sizes"]
    assert sizes["file_bytes"] == os.path.getsize(artifacts["port"])
    _, manifest = _blobs(artifacts["port"])
    assert {tuple(f["path"][:-1]) for f in manifest["floats"]} == \
        {("layer0",)}
    covered = {tuple(c["path"]) for c in manifest["convs"]}
    x = _t(models["x"])
    for zero in (False, True):
        template = _int8_model(seed=3)
        if zero:
            with torch.no_grad():
                for name, mod in template.named_modules():
                    if isinstance(mod, (torch.nn.Conv2d, TL.DeformWeight)) \
                            and not name.startswith("layer0"):
                        mod.weight.zero_()
        w4a8.load_w4a8(artifacts["port"], template)
        with torch.no_grad():
            out = template(x)
        for k, v in models["heads"].items():
            np.testing.assert_array_equal(to_np(out[k]), v, err_msg=k)
    # every int8 conv and deform kernel is covered: 3 per node, 2 more per
    # stride-2 node, layer4, 3 per deconv block, 3 per head
    assert len(covered) == 3 * 16 + 2 * 3 + 1 + 3 * 3 + 3 * 3


def test_artifact_bytes_equal_jax(artifacts):
    """The same model exported by both packages: same manifest, same
    q_blob bytes, same f_blob and qs_blob, every blob the same size,
    scales and folded biases within 1e-6 relative (the BN fold rounds in
    each framework's order)."""
    port, pman = _blobs(artifacts["port"])
    ref, jman = _blobs(artifacts["jax"])
    assert pman == jman
    assert {k: v.nbytes for k, v in port.items()} == \
        {k: v.nbytes for k, v in ref.items()}
    for k in ("q_blob", "f_blob", "qs_blob"):
        np.testing.assert_array_equal(port[k], ref[k], err_msg=k)
    for k in ("s_blob", "b_blob"):
        np.testing.assert_allclose(port[k], ref[k], rtol=1e-6,
                                   atol=1e-6 * np.abs(ref[k]).max(),
                                   err_msg=k)


def test_artifact_loads_across_packages(models, artifacts):
    """A port-written artifact loads in the JAX package's load_w4a8 (its
    deploy tree equal to the JAX-written one's), and a JAX-written one
    loads in the port (its int8 heads within HEAD_TOL of the port's
    checkpoint eval: the JAX fold rounds a few scales differently)."""
    template = models["variables"]
    got = JW._flatten(JW.load_w4a8(artifacts["port"], template)["deploy"])
    want = JW._flatten(JW.load_w4a8(artifacts["jax"], template)["deploy"])
    assert set(got) == set(want)
    for p in want:
        if p[-1] in ("q_w", "w_bit"):
            np.testing.assert_array_equal(got[p], want[p], err_msg=str(p))
        else:
            np.testing.assert_allclose(got[p], want[p], rtol=1e-6,
                                       atol=1e-7, err_msg=str(p))

    model = w4a8.load_w4a8(artifacts["jax"], _int8_model(seed=4))
    with torch.no_grad():
        out = {k: to_np(v) for k, v in model(_t(models["x"])).items()}
    _assert_heads_within(models["heads"], out, HEAD_TOL)


def test_detector_serves_int8_from_checkpoint_and_artifact(
        models, artifacts, tmp_path):
    """tools_torch/export_w4a8.py writes the .pth's artifact (the
    fixture's, blob for blob); CtdetDetector --resume-quantize
    --int8_infer gives equal detections from the .pth (its recipe
    adopted) and from the artifact, and refuses the artifact without
    --int8_infer."""
    import importlib.util
    path = str(tmp_path / "model_last.pth")
    art = str(tmp_path / "model_w4a8.npz")
    checkpoint.save_model(path, 1, models["model"], qspec=INT8)
    args = ["ctdet", "--dataset", "pascal", "--arch", "shufflenetv2",
            "--input_res", "64", "--flip_test", "--resume-quantize"]
    spec = importlib.util.spec_from_file_location(
        "export_w4a8", os.path.join(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))), "tools_torch", "export_w4a8.py"))
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    assert tool.main(args + ["--load_model", path, "--gpus", "-1",
                             "--out", art]) == 0
    got, want = _blobs(art), _blobs(artifacts["port"])
    assert got[1] == want[1]
    for k in want[0]:
        np.testing.assert_array_equal(got[0][k], want[0][k], err_msg=k)

    def detector(*extra):
        opt = tcfg.update_dataset_info_and_set_heads(
            tcfg.parse(args + list(extra)), tcfg.DATASET_SPECS["pascal"])
        return CtdetDetector(opt, device="cpu")
    frame = rng(88).randint(0, 256, (90, 120, 3)).astype(np.uint8)
    dets = []
    for det in (detector("--int8_infer", "--load_model", path),
                detector("--int8_infer", "--w4a8_artifact", art)):
        assert det.qspec.int8_infer
        images, meta = det.pre_process(frame, 1)
        dets.append(to_np(det.process(images, meta["trans_inv"], 1)))
    np.testing.assert_array_equal(dets[0], dets[1])
    with pytest.raises(ValueError, match="int8_infer"):
        detector("--w4a8_artifact", artifacts["port"])
