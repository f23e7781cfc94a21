"""The depthwise 3x3 backward of codenet_torch/ops/dwconv_cuda.py on the
CPU: its plain version and the autograd Function around it against the
JAX package's depthwise conv VJP, the kernel's launch plan at config d's
shapes, the routing predicate, and the model's train step routed as on a
card.

- `dwconv_bwd_plain` and `depthwise_conv3x3`'s gradients (dx, dW, db) at
  config d's channel counts (24, 122, 192, 244, 488) on small maps, odd
  and even, stride 1 and 2, with and without a bias, against `jax.vjp`
  of codenet_tpu's models/layers.py::conv2d plus a bias (1e-5 of each
  gradient's max: f32 sums of at most 2 x 9 x 64 products in another
  order);
- `dw_bwd_plan` at each of config d's depthwise shapes at batch 32 (the
  shapes of tools_torch/roofline.py's rows): shared memory within a
  block's 227 KB and the two-blocks budget, at least the card's 132 SMs
  of blocks, vectors and slices as csrc/dwconv_bwd.cu requires them;
- `dw_route` as a pure function: shapes, devices, grad modes, strides,
  paddings, dilations, dtypes and layouts;
- config d's model (--w2, 64^2) with its routes taken as a card takes
  them: 20 depthwise convs to the kernel a forward with grad, none under
  no_grad, and a train step's gradients equal to the library path's.
"""

import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from test_torch_common import HEADS

from codenet_tpu.models import layers as JL
from codenet_torch.models import create_model
from codenet_torch.models.fused_heads import apply_fused_heads_train
from codenet_torch.ops import deform_cuda as DC
from codenet_torch.ops import dwconv_cuda as DW

sys.path.insert(0, str(Path(__file__).resolve().parent.parent
                       / "tools_torch"))
import roofline as R  # noqa: E402

# config d's depthwise channel counts: layer1.0's b1 (the stem's 24),
# layer1, the fused heads (3 x 64), layer2, layer3
CHANNELS = [24, 122, 192, 244, 488]
MAPS = {"even": (8, 8), "odd": (7, 9)}


def _case(c, hw, stride, seed):
    r = np.random.RandomState(seed)
    h, w = hw
    ho, wo = (h - 1) // stride + 1, (w - 1) // stride + 1
    x = r.randn(2, h, w, c).astype(np.float32)
    k = (r.randn(3, 3, 1, c) * 0.3).astype(np.float32)
    b = r.randn(c).astype(np.float32)
    dy = r.randn(2, ho, wo, c).astype(np.float32)
    return x, k, b, dy


def _jax_grads(x, k, b, dy, stride, bias):
    """dx (NHWC), dk (HWIO) and db of the JAX depthwise conv (+ bias)."""
    c = x.shape[-1]

    def f(x, k, b):
        y = JL.conv2d(x, k, stride, 1, groups=c)
        return y + b if bias else y
    _, vjp = jax.vjp(f, x, k, b)
    return [np.asarray(g) for g in vjp(dy)]


def _close(got, want):
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-5 * float(np.abs(want).max()))


@pytest.mark.parametrize("bias", [False, True], ids=["nobias", "bias"])
@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("hw", sorted(MAPS))
@pytest.mark.parametrize("c", CHANNELS)
def test_plain_backward_matches_jax_vjp(c, hw, stride, bias):
    x, k, b, dy = _case(c, MAPS[hw], stride, seed=c + stride)
    jdx, jdk, jdb = _jax_grads(x, k, b, dy, stride, bias)
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    wt = torch.from_numpy(k).permute(3, 2, 0, 1).contiguous()
    bt = torch.from_numpy(b)
    dyt = torch.from_numpy(dy).permute(0, 3, 1, 2)
    dx, dw, db = DW.dwconv_bwd_plain(xt, wt, dyt, stride, bias)
    # the Function's backward (the plain version on the CPU)
    leaves = [t.clone().requires_grad_() for t in (xt, wt, bt)]
    y = DW.depthwise_conv3x3(leaves[0], leaves[1],
                             leaves[2] if bias else None, stride)
    assert tuple(y.shape) == tuple(dyt.shape)
    y.backward(dyt)
    for got_dx, got_dw in ((dx, dw), (leaves[0].grad, leaves[1].grad)):
        _close(got_dx.permute(0, 2, 3, 1).numpy(), jdx)
        _close(got_dw.permute(2, 3, 1, 0).numpy(), jdk)
    if bias:
        _close(db.numpy(), jdb)
        _close(leaves[2].grad.numpy(), jdb)
    else:
        assert db is None and leaves[2].grad is None


def _config_d_shapes(batch=32):
    """{(h, w, c, stride): count} of config d's depthwise 3x3 convs in a
    train step at 512^2 (roofline.py's rows: 20 convs, 8 shapes)."""
    m = R.build(512, True, batch, "f32", fused_heads=True, train=True)
    out = {}
    for r in m.rows:
        if r.kind == "conv" and r.k == 3 and r.groups == r.cin == r.cout:
            key = (r.h, r.w, r.cin, r.stride)
            out[key] = out.get(key, 0) + 1
    return out


def test_config_d_has_20_depthwise_convs_in_8_shapes():
    shapes = _config_d_shapes()
    assert sum(shapes.values()) == 20 and len(shapes) == 8
    assert shapes[(64, 64, 122, 1)] == 3 and shapes[(32, 32, 244, 1)] == 7
    assert shapes[(128, 128, 192, 1)] == 1


@pytest.mark.parametrize("shape", sorted(_config_d_shapes()),
                         ids=lambda s: "x".join(map(str, s)))
def test_plan_limits_at_config_d(shape):
    h, w, c, stride = shape
    plan = DW.dw_bwd_plan(32, h, w, c, stride)
    ho = (h - 1) // stride + 1
    assert plan["smem_bytes"] <= DW.SMEM_BUDGET < DC.SMEM_PER_BLOCK
    assert plan["smem_bytes"] == DW.dw_bwd_smem_bytes(
        w, plan["cb"], plan["vec"], plan["rows"], stride)
    assert plan["blocks"] >= DC.NUM_SMS
    assert plan["vec"] == (4 if c % 4 == 0 else 2)
    cbv = plan["cb"] // plan["vec"]
    assert cbv & (cbv - 1) == 0 and cbv <= DW.MAX_SLICE_VECS
    assert DW.THREADS % cbv == 0
    # 122 and 244 channels start a position off a 32-byte sector
    assert plan["cb"] * 4 >= DW.min_slice_bytes(c) \
        == (64 if c in (122, 244) else 32)
    assert 1 <= plan["rows"] <= ho
    assert plan["bands"] == -(-ho // plan["rows"])
    assert plan["slices"] == -(-c // plan["cb"])
    assert plan["blocks"] == 32 * plan["bands"] * plan["slices"]


@pytest.mark.parametrize("c,align,vec", [(488, 16, 4), (122, 16, 2),
                                         (61, 16, 1), (488, 8, 2),
                                         (488, 4, 1)])
def test_plan_vector_follows_channels_and_alignment(c, align, vec):
    assert DW.dw_bwd_plan(2, 16, 16, c, 1, align=align)["vec"] == vec


def test_plan_refuses_a_map_wider_than_a_block():
    with pytest.raises(ValueError):
        DW.dw_bwd_plan(1, 4, 40000, 4, 1)


CL, ANY = True, False
# (x shape, weight shape, groups, stride, padding, dilation, device,
#  dtype, channels_last, grad) -> route
ROUTES = {
    "s1": (((32, 122, 64, 64), (122, 1, 3, 3), 122, 1, 1, 1, "cuda",
            torch.float32, CL, True), "kernel"),
    "s2": (((32, 244, 64, 64), (244, 1, 3, 3), 244, 2, 1, 1, "cuda",
            torch.float32, CL, True), "kernel"),
    "tuples": (((2, 24, 7, 9), (24, 1, 3, 3), 24, (2, 2), (1, 1), (1, 1),
                "cuda", torch.float32, CL, True), "kernel"),
    "s3": (((2, 24, 9, 9), (24, 1, 3, 3), 24, 3, 1, 1, "cuda",
            torch.float32, CL, True), "library"),
    "s12": (((2, 24, 9, 9), (24, 1, 3, 3), 24, (1, 2), 1, 1, "cuda",
             torch.float32, CL, True), "library"),
    "band_padding": (((2, 24, 10, 8), (24, 1, 3, 3), 24, 1, (0, 1), 1,
                      "cuda", torch.float32, CL, True), "library"),
    "padding0": (((2, 24, 8, 8), (24, 1, 3, 3), 24, 1, 0, 1, "cuda",
                  torch.float32, CL, True), "library"),
    "dilation2": (((2, 24, 8, 8), (24, 1, 3, 3), 24, 1, 1, 2, "cuda",
                   torch.float32, CL, True), "library"),
    "bf16": (((2, 24, 8, 8), (24, 1, 3, 3), 24, 1, 1, 1, "cuda",
              torch.bfloat16, CL, True), "library"),
    "f64": (((2, 24, 8, 8), (24, 1, 3, 3), 24, 1, 1, 1, "cuda",
             torch.float64, CL, True), "library"),
    "nchw": (((2, 24, 8, 8), (24, 1, 3, 3), 24, 1, 1, 1, "cuda",
              torch.float32, ANY, True), "library"),
    "cpu": (((2, 24, 8, 8), (24, 1, 3, 3), 24, 1, 1, 1, "cpu",
             torch.float32, CL, True), None),
    "no_grad": (((2, 24, 8, 8), (24, 1, 3, 3), 24, 1, 1, 1, "cuda",
                 torch.float32, CL, False), None),
    "dense": (((2, 24, 8, 8), (24, 24, 3, 3), 1, 1, 1, 1, "cuda",
               torch.float32, CL, True), None),
    "grouped": (((2, 24, 8, 8), (24, 2, 3, 3), 12, 1, 1, 1, "cuda",
                 torch.float32, CL, True), None),
    "multiplier2": (((2, 24, 8, 8), (48, 1, 3, 3), 24, 1, 1, 1, "cuda",
                     torch.float32, CL, True), None),
    "k1": (((2, 24, 8, 8), (24, 1, 1, 1), 24, 1, 0, 1, "cuda",
            torch.float32, CL, True), None),
    "k5": (((2, 24, 8, 8), (24, 1, 5, 5), 24, 1, 2, 1, "cuda",
            torch.float32, CL, True), None),
}


@pytest.mark.parametrize("name", sorted(ROUTES))
def test_route_predicate(name):
    args, want = ROUTES[name]
    assert DW.dw_route(*args) == want


def _d_model(dtype=None):
    model = create_model("shufflenetv2", HEADS, 64, w2=True, dtype=dtype,
                         device="cpu")
    model.train()
    return model


def _step_grads(model, x):
    out = apply_fused_heads_train(model, model(x, return_neck=True))
    loss = sum((v.float() ** 2).mean() for v in out.values())
    grads = torch.autograd.grad(loss, list(model.parameters()))
    return float(loss.detach()), grads


@pytest.mark.parametrize("dtype", [None, torch.bfloat16], ids=["f32",
                                                                "bf16"])
def test_config_d_step_routed_as_on_a_card(dtype, monkeypatch):
    """Every call routed as on a card (dw_route told the device is
    "cuda"): each forward with grad sends config d's 20 depthwise convs to
    the Function (whose CPU backward is the plain version) and none to
    the library; the step's loss and gradients equal the library path's
    (1e-6 of each gradient's max: the plain backward is cuDNN's / the
    CPU's own dgrad and wgrad called apart); under no_grad no call
    counts."""
    x = torch.from_numpy(np.random.RandomState(5).randn(2, 64, 64, 3)
                         .astype(np.float32))
    model = _d_model(dtype)
    state = {k: v.clone() for k, v in model.state_dict().items()}
    ref_loss, ref = _step_grads(model, x)
    model.load_state_dict(state)
    route = DW.dw_route
    monkeypatch.setattr(DW, "dw_route", lambda *a: route(
        *a[:6], "cuda" if a[6] == "cpu" else a[6], *a[7:]))
    monkeypatch.setattr(DW, "DW_ROUTES", {"kernel": 0, "library": 0})
    calls = []
    fn = DW.depthwise_conv3x3
    monkeypatch.setattr(DW, "depthwise_conv3x3",
                        lambda *a: calls.append(a[3]) or fn(*a))
    loss, got = _step_grads(model, x)
    assert DW.DW_ROUTES == {"kernel": 20, "library": 0}
    assert sorted(calls) == [1] * 14 + [2] * 6
    assert loss == pytest.approx(ref_loss, rel=1e-6)
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), r.numpy(), rtol=0,
                                   atol=1e-6 * float(r.abs().max()) + 1e-30)
    with torch.no_grad():
        model(x, return_neck=True)
    assert DW.DW_ROUTES == {"kernel": 20, "library": 0} and len(calls) == 20
