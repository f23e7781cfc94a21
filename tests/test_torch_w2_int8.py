"""Real int8 of the paper's 2x configs (d: --w2, e: --w2 --maxpool)
against the JAX package, and the integer sums that int8 trusts to f32.

At 64^2 (deconv0's map 2x2x2153): the port's int8 heads held against the
JAX int8 model's (Pallas in interpret mode, so that both sample the
deform conv in bf16) with tests/test_torch_int8.py's tolerances; the
2x artifact's bytes equal to the JAX exporter's, run eagerly (jitted,
XLA folds BN in another order and a level at a rounding tie flips), and
within the JAX package's band of the reference's 2.90 MB; and, for
every int8 conv of configs d and e, the largest |partial sum| the
integer levels allow, below 2^24 (ops/quant.py::int8_conv_terms sums
them in f32 and must sum exactly). Each model is built once per config.
"""

import json
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from test_torch_common import HEADS, perturb_variables, rng, to_np

from codenet_tpu.engine import w4a8 as JW
from codenet_tpu.engine.torch_import import convert_shufflenetv2
from codenet_tpu.models import create_model as jax_create_model
from codenet_tpu.models.layers import QuantSpec as JaxQuantSpec
from codenet_torch.engine import w4a8
from codenet_torch.engine.jax_weights import (from_jax_variables,
                                              to_jax_variables)
from codenet_torch.models import create_model
from codenet_torch.models.layers import QuantSpec
from codenet_torch.ops import quant as TQ

from test_torch_int8 import HEAD_TOL, _assert_heads_within

# config -> (w2, maxpool)
CONFIGS = {"d": (True, False), "e": (True, True)}
# the reference's 2x W4A8 parameter files (its README.md:14-18), and the
# JAX package's band around it (tests/test_w4a8_export.py)
REFERENCE_2X_MB, SIZE_BAND = 2.90, 0.25
EXACT_F32 = 2 ** 24


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope="module", params=list(CONFIGS))
def config(request):
    """One config's seeded weights (calibrated BN, ranges from two
    fake-quant update passes), its port int8 model, JAX variables, input
    and port int8 heads."""
    w2, maxpool = CONFIGS[request.param]
    base = create_model("shufflenetv2", HEADS, 64, w2=w2, maxpool=maxpool,
                        device="cpu")
    sd = {k: v.numpy() for k, v in base.state_dict().items()}
    variables = perturb_variables(convert_shufflenetv2(sd), seed=90,
                                  w2=w2, maxpool=maxpool)
    x = (rng(91).randn(2, 64, 64, 3) * 0.5).astype(np.float32)
    fake = create_model("shufflenetv2", HEADS, 64, w2=w2, maxpool=maxpool,
                        qspec=QuantSpec(), device="cpu")
    fake.load_state_dict(from_jax_variables(variables), strict=False)
    with torch.no_grad():
        for _ in range(2):
            fake(_t(x), update_stats=True)
    model = create_model("shufflenetv2", HEADS, 64, w2=w2, maxpool=maxpool,
                         qspec=QuantSpec(int8_infer=True), device="cpu")
    model.load_state_dict(fake.state_dict())
    variables["quant_stats"] = to_jax_variables(
        fake.state_dict())["quant_stats"]
    with torch.no_grad():
        heads = {k: to_np(v) for k, v in model(_t(x)).items()}
    return {"name": request.param, "w2": w2, "maxpool": maxpool,
            "model": model, "variables": variables, "x": x, "heads": heads}


def _jax_model(config):
    return jax_create_model("shufflenetv2", HEADS, 64, w2=config["w2"],
                            maxpool=config["maxpool"],
                            qspec=JaxQuantSpec(int8_infer=True))


def test_w2_int8_heads_match_jax(config, monkeypatch):
    monkeypatch.setenv("CODENET_PALLAS_INTERPRET", "1")
    ref = jax.jit(_jax_model(config).apply)(config["variables"],
                                            jnp.asarray(config["x"]))
    assert ref["hm"].shape == (2, 16, 16, 20)
    _assert_heads_within({k: np.asarray(v) for k, v in ref.items()},
                         config["heads"], HEAD_TOL)


def _blobs(path):
    with np.load(path) as z:
        arrays = {k: z[k] for k in z.files}
    manifest = json.loads(bytes(arrays.pop("manifest").tobytes()).decode())
    return arrays, manifest


def test_w2_artifact_bytes_equal_jax_and_near_reference(config, tmp_path):
    """The config's artifact written by both packages: the same
    manifest, q_blob, f_blob and qs_blob bytes, every blob the same size,
    scales and folded biases within 1e-6 relative, the file within 25%
    of 2.90 MB. The exporter's forward only sows the weights' levels,
    scales and folded biases, which no deform path changes: the JAX one
    runs on its XLA deform path (in Pallas interpret mode, eagerly, it
    takes a minute)."""
    port_path, jax_path = str(tmp_path / "port.npz"), str(tmp_path / "jax.npz")
    sizes = w4a8.export_w4a8(config["model"], (64, 64), port_path)
    JW.export_w4a8(_jax_model(config), config["variables"], (64, 64),
                   jax_path)
    port, pman = _blobs(port_path)
    ref, jman = _blobs(jax_path)
    assert pman == jman
    assert {k: v.nbytes for k, v in port.items()} == \
        {k: v.nbytes for k, v in ref.items()}
    for k in ("q_blob", "f_blob", "qs_blob"):
        np.testing.assert_array_equal(port[k], ref[k], err_msg=k)
    for k in ("s_blob", "b_blob"):
        np.testing.assert_allclose(port[k], ref[k], rtol=1e-6,
                                   atol=1e-6 * np.abs(ref[k]).max(),
                                   err_msg=k)
    mb = sizes["file_bytes"] / 1e6
    assert sizes["file_bytes"] == os.path.getsize(jax_path)
    assert abs(mb - REFERENCE_2X_MB) / REFERENCE_2X_MB < SIZE_BAND, sizes


def test_int8_partial_sums_exact_in_f32(config, monkeypatch):
    """Every int8 conv of one forward of config d or e: its fan-in per
    output (Cin / groups x kh x kw) times the largest activation level
    (128) and weight level (2^(w_bit - 1): 8 at 4 bits, 128 for layer0's
    8 bits) bounds every partial sum of the accumulator, whatever the
    order; it stays below 2^24, where f32 holds every integer. The
    largest is deconv0's 1x1 mixer over 2153 channels: 2153 x 128 x 8 =
    2,204,672. The accumulators also equal the exact f64 sums."""
    calls = []
    conv = TQ.int8_conv

    def record(qx, q_w, *args, **kw):
        calls.append((qx, q_w, args))
        return conv(qx, q_w, *args, **kw)
    monkeypatch.setattr(TQ, "int8_conv", record)
    with torch.no_grad():
        config["model"](_t(config["x"]))
    assert len(calls) == 70
    bounds = []
    for qx, q_w, args in calls:
        o, cin_g, kh, kw = q_w.shape
        # layer0, the only conv of the 3 image channels, has 8-bit weights
        w_bit = 8 if cin_g == 3 else 4
        assert int(q_w.abs().max()) <= 2 ** (w_bit - 1)
        bound = cin_g * kh * kw * 128 * 2 ** (w_bit - 1)
        # the levels this model has: sum of |q| over each output's taps
        tight = int(q_w.abs().sum((1, 2, 3)).max()) * 128
        bounds.append((bound, tight, tuple(q_w.shape)))
        assert tight <= bound < EXACT_F32, (q_w.shape, bound)
        acc, wsum = TQ.int8_conv_terms(qx.values, q_w, *args[2:])
        ref_acc, ref_wsum = TQ.int8_conv_terms(qx.values.double(),
                                               q_w.double(), *args[2:])
        assert torch.equal(acc.double(), ref_acc)
        assert torch.equal(wsum.double(), ref_wsum)
    worst = max(bounds)
    assert worst[0] == 2153 * 128 * 8 and worst[2][1] == 2153
