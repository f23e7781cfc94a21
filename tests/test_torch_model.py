"""The port's layers, full model and ctdet decode against the JAX package.

The full ShuffleNetV2-DCN 1x model (every width as served, 64^2 input,
batch 2) is initialised by JAX, perturbed with numpy so that the deform
scale s is fractional and partly outside the map, carried across with
`from_jax_variables`, and its heads compared with the JAX eval forward,
which reaches the Pallas kernel in interpret mode.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from test_torch_common import (HEADS, assert_heads_close, perturb_variables,
                               rng, to_np)

from codenet_tpu.models import create_model as jax_create_model
from codenet_tpu.models import decode as JD
from codenet_tpu.models import layers as JL
from codenet_tpu.models.fused_heads import eval_forward
from codenet_torch import resolve_device
from codenet_torch.engine.jax_weights import from_jax_variables
from codenet_torch.models import create_model
from codenet_torch.models import decode as TD
from codenet_torch.models import layers as TL


def test_model_matches_jax(monkeypatch):
    monkeypatch.setenv("CODENET_PALLAS_INTERPRET", "1")
    jmodel = jax_create_model("shufflenetv2", HEADS, 64)
    variables = jax.jit(jmodel.init)(jax.random.PRNGKey(0),
                                     jnp.zeros((1, 64, 64, 3)))
    variables = perturb_variables(dict(variables), seed=10)
    x = rng(11).randn(2, 64, 64, 3).astype(np.float32)
    ref = jax.jit(lambda v, x: eval_forward(jmodel, v, x))(
        variables, jnp.asarray(x))

    model = create_model("shufflenetv2", HEADS, 64, device="cpu")
    model.load_state_dict(from_jax_variables(variables))
    with torch.no_grad():
        out = model(torch.from_numpy(x))
    assert [k for k, _ in model.heads] == ["hm", "reg", "wh"]
    assert_heads_close({k: np.asarray(v) for k, v in ref.items()},
                       {k: to_np(v) for k, v in out.items()})


def test_model_layout_and_memory_format():
    model = create_model("shufflenetv2", HEADS, 64, device="cpu")
    assert not model.training
    conv = model.layer1[0].b2[0]
    assert conv.weight.is_contiguous(memory_format=torch.channels_last)
    with torch.no_grad():
        out = model(torch.zeros(1, 32, 64, 3))
    assert {k: tuple(v.shape) for k, v in out.items()} == {
        "hm": (1, 8, 16, 20), "reg": (1, 8, 16, 2), "wh": (1, 8, 16, 2)}


def test_w2_maxpool_widths():
    """--w2 doubles the widths (deconv0 reads C=2153); --maxpool adds the
    stem pool; both honoured as in the JAX factory."""
    model = create_model("shufflenetv2", HEADS, 64, w2=True, maxpool=True,
                         device="cpu")
    assert model.layer4[0].out_channels == 2153
    assert model.deconv_layers[0].conv.weight.shape == (2153, 1, 3, 3)
    assert isinstance(model.layer0[3], torch.nn.MaxPool2d)
    with torch.no_grad():
        out = model(torch.zeros(1, 64, 64, 3))
    assert out["hm"].shape == (1, 16, 16, 20)


def test_init_is_seeded_and_matches_jax_rules():
    a = create_model("shufflenetv2", HEADS, 64, device="cpu",
                     generator=torch.Generator().manual_seed(3))
    b = create_model("shufflenetv2", HEADS, 64, device="cpu",
                     generator=torch.Generator().manual_seed(3))
    for (ka, va), (kb, vb) in zip(a.state_dict().items(),
                                  b.state_dict().items()):
        assert ka == kb and torch.equal(va, vb), ka
    blk = a.deconv_layers[0]
    assert torch.all(blk.conv_scale.weight == 0)
    assert torch.all(blk.conv_scale.bias == 1)
    bound = 1.0 / np.sqrt(1024 * 9)
    assert float(blk.conv.weight.detach().abs().max()) <= bound
    assert torch.all(a.hm[6].bias == -2.19)
    assert torch.all(a.wh[6].bias == 0)


@pytest.mark.parametrize("kwargs", [dict(arch="res_18"),
                                    dict(deform_backbone=True),
                                    dict(dtype="bfloat16")])
def test_unported_options_raise(kwargs):
    """Options once unported: the res_18 arch, the deform backbone and
    the bf16 model, ported since, keep their case ids and check that a
    forward runs: finite f32 heads of the right shape
    (tests/test_torch_resnet.py, test_torch_deform_backbone.py and
    test_torch_bf16.py hold them against the JAX package); an arch the
    JAX package does not have either raises."""
    args = dict(arch="shufflenetv2", heads=HEADS, head_conv=64,
                device="cpu")
    args.update(kwargs)
    if "arch" in kwargs:
        with pytest.raises(ValueError, match="unknown arch"):
            create_model(**dict(args, arch="mobilenet_2"))
    with torch.no_grad():
        out = create_model(**args)(torch.zeros(1, 64, 64, 3))
    for name, classes in HEADS.items():
        assert out[name].shape == (1, 16, 16, classes)
        assert out[name].dtype == torch.float32
        assert torch.isfinite(out[name]).all()


def test_cuda_without_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        resolve_device("cuda")
    with pytest.raises(RuntimeError, match="no CUDA card"):
        create_model("shufflenetv2", HEADS, 64)


def test_layer_helpers_match_jax():
    x = rng(12).randn(2, 5, 7, 8).astype(np.float32)
    xt = torch.from_numpy(x)
    np.testing.assert_array_equal(
        to_np(TL.channel_shuffle(xt, 2)),
        np.asarray(JL.channel_shuffle(jnp.asarray(x), 2)))
    np.testing.assert_array_equal(
        to_np(TL.upsample_nearest_2x(xt)),
        np.asarray(JL.upsample_nearest_2x(jnp.asarray(x))))
    np.testing.assert_array_equal(
        to_np(TL.max_pool(xt, 3, 2, 1)),
        np.asarray(JL.max_pool(jnp.asarray(x), 3, 2, 1)))


# -- decode -----------------------------------------------------------------

def _tie_free_heads(seed, n=2, h=16, w=12, c=5):
    """Heatmap values are a random permutation of distinct levels, so no
    two scores tie: torch.topk and lax.top_k may order ties differently,
    and tie-free maps make both selections and orders unique."""
    r = rng(seed)
    hm = (r.permutation(n * h * w * c).astype(np.float32) + 1.0) \
        / (n * h * w * c + 1.0)
    hm = hm.reshape(n, h, w, c)
    wh = r.uniform(1.0, 8.0, (n, h, w, 2)).astype(np.float32)
    reg = r.uniform(0.0, 1.0, (n, h, w, 2)).astype(np.float32)
    return hm, wh, reg


def test_heat_nms_matches_jax():
    hm, _, _ = _tie_free_heads(13)
    np.testing.assert_array_equal(
        to_np(TD.heat_nms(torch.from_numpy(hm))),
        np.asarray(JD.heat_nms(jnp.asarray(hm))))


@pytest.mark.parametrize("method", ["pooled", "two_stage"])
@pytest.mark.parametrize("shape", [(16, 12), (15, 11)])
def test_topk_matches_jax(method, shape):
    hm, _, _ = _tie_free_heads(14, h=shape[0], w=shape[1])
    hm = np.array(JD.heat_nms(jnp.asarray(hm)))
    ref = JD.topk(jnp.asarray(hm), 20, method=method)
    out = TD.topk(torch.from_numpy(hm), 20, method=method)
    for a, b in zip(ref, out):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())


@pytest.mark.parametrize("reg_on", [True, False])
def test_ctdet_decode_and_backproject_match_jax(reg_on):
    hm, wh, reg = _tie_free_heads(15)
    ref = JD.ctdet_decode(jnp.asarray(hm), jnp.asarray(wh),
                          reg=jnp.asarray(reg) if reg_on else None, k=30)
    out = TD.ctdet_decode(torch.from_numpy(hm), torch.from_numpy(wh),
                          reg=torch.from_numpy(reg) if reg_on else None,
                          k=30)
    assert out.shape == (2, 30, 6)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-6,
                               atol=1e-5)
    t = rng(16).randn(2, 2, 3).astype(np.float32)
    np.testing.assert_allclose(
        TD.backproject_dets(out, torch.from_numpy(t), 0.5).numpy(),
        np.asarray(JD.backproject_dets(ref, jnp.asarray(t), 0.5)),
        rtol=1e-5, atol=1e-4)


def test_cat_spec_wh_decode_matches_jax():
    hm, _, reg = _tie_free_heads(17, c=3)
    wh = rng(18).uniform(1.0, 8.0, hm.shape[:3] + (6,)).astype(np.float32)
    ref = JD.ctdet_decode(jnp.asarray(hm), jnp.asarray(wh),
                          reg=jnp.asarray(reg), cat_spec_wh=True, k=10)
    out = TD.ctdet_decode(torch.from_numpy(hm), torch.from_numpy(wh),
                          reg=torch.from_numpy(reg), cat_spec_wh=True, k=10)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-6,
                               atol=1e-5)
