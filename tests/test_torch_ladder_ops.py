"""The deform-conv ladder (models/deform_modules.py) and the op inventory
(ops/abn.py, ops/roi_align.py, ops/deform_pool.py) of the port against
the JAX package, on seeded numpy inputs:

- every rung on carried weights (`engine/jax_weights.py::
  deform_module_to_jax`, predictors perturbed off their zero init so the
  offsets, bounds, rounding and masks all act): output within 2e-3 and
  the gradients of the input and of every parameter within 5e-3 of each
  one's max; the weights back with `deform_module_from_jax` exactly;
- the ports of tests/test_deform_modules.py: every rung's output shape,
  the zero-init packs equal a plain conv, DCNv2's mask 0.5 at init;
- the ports of tests/test_inventory_ops.py: ROI-Align against the CUDA
  loop oracle (fixed and adaptive grid), its boundary and malformed
  ROIs, finite-difference gradients (f64), and against the JAX op with
  its gradients; InPlace-ABN against its autodiff oracle in every
  activation and with frozen statistics, against the JAX op, the
  module's running statistics; a saved_tensors_hooks check that ABN
  saves no tensor of x's storage;
- deformable PS-ROI pooling against the JAX op (with and without
  offsets; gradients of the data and the offsets) and its uniform-input
  case.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
import torch.nn.functional as F

from test_inventory_ops import _rand_rois, _roi_align_np
from test_torch_common import nchw_to_nhwc, nhwc_to_nchw, rng, to_np

from codenet_tpu.models import deform_modules as JDM
from codenet_tpu.ops import abn as JA
from codenet_tpu.ops.deform_pool import deform_psroi_pooling as j_psroi
from codenet_tpu.ops.roi_align import roi_align as j_roi_align
from codenet_torch.engine.jax_weights import (deform_module_from_jax,
                                              deform_module_to_jax)
from codenet_torch.models import deform_modules as DM
from codenet_torch.ops import abn as A
from codenet_torch.ops.deform_pool import deform_psroi_pooling
from codenet_torch.ops.roi_align import roi_align

FWD_TOL, GRAD_TOL = 2e-3, 5e-3
CIN, COUT = 6, 5

# rung -> (port module, JAX module, predictor weight scale)
RUNGS = {
    "pack": (lambda: DM.DeformConvPack(CIN, COUT),
             lambda: JDM.DeformConvPack(COUT), 0.3),
    "pack_1x1": (lambda: DM.DeformConvPack1x1(CIN, COUT),
                 lambda: JDM.DeformConvPack1x1(COUT), 0.5),
    "pack_dw": (lambda: DM.DeformConvPackDW(CIN, COUT),
                lambda: JDM.DeformConvPackDW(COUT), 0.5),
    "modulated": (lambda: DM.ModulatedDeformConvPack(CIN, COUT),
                  lambda: JDM.ModulatedDeformConvPack(COUT), 0.3),
    "bound": (lambda: DM.DeformConvWithOffsetBound(CIN, COUT, 1),
              lambda: JDM.DeformConvWithOffsetBound(COUT, 1), 0.4),
    "round": (lambda: DM.DeformConvWithOffsetRound(CIN, COUT),
              lambda: JDM.DeformConvWithOffsetRound(COUT), 0.3),
    "scale": (lambda: DM.DeformConvWithOffsetScale(CIN, COUT),
              lambda: JDM.DeformConvWithOffsetScale(COUT), 0.15),
    "scale_bound": (lambda: DM.DeformConvWithOffsetScaleBound(CIN, COUT, 2),
                    lambda: JDM.DeformConvWithOffsetScaleBound(COUT, 2),
                    0.3),
    "scale_bound_positive": (
        lambda: DM.ModulatedDeformConvWithOffsetScaleBoundPositive(
            CIN, COUT, 2),
        lambda: JDM.ModulatedDeformConvWithOffsetScaleBoundPositive(COUT, 2),
        0.3),
}


def _assert_close(ref, got, tol, what):
    ref, got = np.asarray(ref), np.asarray(got)
    scale = max(float(np.abs(ref).max()), 1e-6)
    err = float(np.abs(got - ref).max())
    assert err <= tol * scale, (what, err, scale)


def _rung_pair(name, seed):
    """A port rung at the JAX init from a seeded generator, each predictor
    (conv_*) moved off zero by seeded noise, and its flax params."""
    make, _, scale = RUNGS[name]
    mod = make()
    mod.reset_parameters(torch.Generator().manual_seed(seed))
    r = rng(seed)
    with torch.no_grad():
        for key, p in mod.named_parameters():
            if key.startswith("conv_"):
                p.add_(torch.from_numpy(
                    (r.randn(*p.shape) * scale).astype(np.float32)))
            elif key == "bias":
                p.copy_(torch.from_numpy(r.randn(*p.shape)
                                         .astype(np.float32)))
    return mod, deform_module_to_jax(mod.state_dict())


@pytest.mark.parametrize("name", list(RUNGS))
def test_rung_matches_jax(name):
    mod, params = _rung_pair(name, 200)
    x = rng(201).randn(2, 8, 8, CIN).astype(np.float32)
    cot = rng(202).randn(2, 8, 8, COUT).astype(np.float32)
    jmod = RUNGS[name][1]()

    def jfn(p, xx):
        y = jmod.apply({"params": p}, xx)
        return jnp.sum(y * cot), y
    (_, ref), (gp, gx) = jax.value_and_grad(jfn, argnums=(0, 1),
                                            has_aux=True)(
        jax.tree_util.tree_map(jnp.asarray, params), jnp.asarray(x))
    xt = torch.from_numpy(nhwc_to_nchw(x)).requires_grad_()
    y = mod(xt)
    (y * torch.from_numpy(nhwc_to_nchw(cot))).sum().backward()
    _assert_close(ref, nchw_to_nhwc(to_np(y)), FWD_TOL, "out")
    _assert_close(gx, nchw_to_nhwc(to_np(xt.grad)), GRAD_TOL, "x")
    grads = deform_module_from_jax(jax.tree_util.tree_map(np.asarray, gp))
    named = dict(mod.named_parameters())
    assert set(grads) == set(named)
    for key, g in grads.items():
        _assert_close(g.numpy(), to_np(named[key].grad), GRAD_TOL, key)
    back = deform_module_from_jax(params)
    for key, v in mod.state_dict().items():
        assert torch.equal(back[key], v), key


def test_ladder_forward_shapes_and_jax_init():
    """Every rung at its JAX init: the output shape, and the init's zero
    predictors carried to the JAX module give its output."""
    x = rng(203).randn(1, 8, 8, CIN).astype(np.float32)
    for name, (make, jmake, _) in RUNGS.items():
        mod = make()
        mod.reset_parameters(torch.Generator().manual_seed(0))
        with torch.no_grad():
            y = mod(torch.from_numpy(nhwc_to_nchw(x)))
        assert tuple(y.shape) == (1, COUT, 8, 8), name
        ref = jmake().apply({"params": deform_module_to_jax(
            mod.state_dict())}, jnp.asarray(x))
        _assert_close(ref, nchw_to_nhwc(to_np(y)), FWD_TOL, name)


def test_zero_init_packs_equal_plain_conv():
    """Offset predictors at zero: a standard conv; DCNv2's mask at zero
    scales it by sigmoid(0) = 0.5."""
    x = torch.from_numpy(rng(204).randn(1, 4, 8, 8).astype(np.float32))
    for make, factor in ((lambda: DM.DeformConvPack(4, 5), 1.0),
                         (lambda: DM.DeformConvPack1x1(4, 5), 1.0),
                         (lambda: DM.DeformConvWithOffsetScale(4, 5), 1.0),
                         (lambda: DM.ModulatedDeformConvPack(4, 5), 0.5)):
        mod = make()
        mod.reset_parameters(torch.Generator().manual_seed(1))
        with torch.no_grad():
            y = mod(x)
            ref = F.conv2d(x, mod.weight, padding=1) * factor
        np.testing.assert_allclose(to_np(y), to_np(ref), rtol=1e-4,
                                   atol=1e-5)


# -- ROI-Align ----------------------------------------------------------------

@pytest.mark.parametrize("sampling_ratio", [2, 0])
def test_roi_align_matches_cuda_loop_oracle(sampling_ratio):
    r = np.random.RandomState(0)
    n, h, w, c = 2, 16, 20, 8
    scale = 1.0 / 4
    x = r.randn(n, h, w, c).astype(np.float32)
    rois = _rand_rois(r, n, h, w, r=7, scale=scale)
    got = roi_align(torch.from_numpy(x), torch.from_numpy(rois), 5, 3,
                    scale, sampling_ratio)
    want = _roi_align_np(x, rois, 5, 3, scale, sampling_ratio)
    np.testing.assert_allclose(to_np(got), want, rtol=1e-4, atol=1e-5)


def test_roi_align_boundary_and_malformed_rois():
    """ROIs across every edge (the [-1, 0] clamp band, the far-edge
    corner collapse, wholly outside), and a malformed one (x2 < x1)
    forced to 1x1."""
    x = np.random.RandomState(5).randn(1, 6, 6, 2).astype(np.float32)
    rois = np.array([[0, -8.0, -8.0, 4.0, 4.0], [0, 20.0, 20.0, 40.0, 40.0],
                     [0, -30.0, -30.0, -20.0, -20.0]], np.float32)
    got = roi_align(torch.from_numpy(x), torch.from_numpy(rois), 4, 4, 0.25,
                    2)
    np.testing.assert_allclose(to_np(got), _roi_align_np(x, rois, 4, 4, 0.25,
                                                         2),
                               rtol=1e-4, atol=1e-5)
    out = roi_align(torch.ones(1, 8, 8, 2),
                    torch.tensor([[0, 5.0, 5.0, 4.0, 4.0]]), 2, 2, 1.0, 1)
    assert torch.isfinite(out).all()
    np.testing.assert_allclose(to_np(out), 1.0, atol=1e-6)


def test_roi_align_grad_finite_difference():
    r = np.random.RandomState(1)
    x = r.randn(1, 6, 7, 2)
    rois = torch.from_numpy(_rand_rois(r, 1, 6, 7, r=2, scale=0.5)
                            .astype(np.float64))
    cot = torch.from_numpy(r.randn(2, 3, 3, 2))

    def loss(xt):
        return (roi_align(xt, rois, 3, 3, 0.5, 2) * cot).sum()
    xt = torch.from_numpy(x).requires_grad_()
    loss(xt).backward()
    eps = 1e-6
    for i in r.choice(x.size, 20, replace=False):
        ij = np.unravel_index(i, x.shape)
        xp, xm = x.copy(), x.copy()
        xp[ij] += eps
        xm[ij] -= eps
        fd = (float(loss(torch.from_numpy(xp)))
              - float(loss(torch.from_numpy(xm)))) / (2 * eps)
        assert abs(fd - float(xt.grad[ij])) < 1e-5, (ij, fd)


@pytest.mark.parametrize("sampling_ratio", [2, 0])
def test_roi_align_matches_jax(sampling_ratio):
    r = np.random.RandomState(2)
    x = r.randn(2, 12, 14, 5).astype(np.float32)
    rois = _rand_rois(r, 2, 12, 14, r=5, scale=0.5)
    cot = r.randn(5, 4, 3, 5).astype(np.float32)

    def jfn(xx):
        y = j_roi_align(xx, jnp.asarray(rois), pooled_height=4,
                        pooled_width=3, spatial_scale=0.5,
                        sampling_ratio=sampling_ratio)
        return jnp.sum(y * cot), y
    (_, ref), gref = jax.value_and_grad(jfn, has_aux=True)(jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_()
    y = roi_align(xt, torch.from_numpy(rois), 4, 3, 0.5, sampling_ratio)
    (y * torch.from_numpy(cot)).sum().backward()
    _assert_close(ref, to_np(y), FWD_TOL, "out")
    _assert_close(gref, to_np(xt.grad), GRAD_TOL, "x")


# -- InPlace-ABN --------------------------------------------------------------

def _abn_case(seed):
    r = np.random.RandomState(seed)
    x = r.randn(4, 6, 6, 5).astype(np.float32)
    w = r.randn(5).astype(np.float32)  # mixed signs: |w| + eps
    b = r.randn(5).astype(np.float32)
    cot = r.randn(4, 6, 6, 5).astype(np.float32)
    return x, w, b, cot


def _batch_stats(x):
    mean = x.mean(dim=(0, 1, 2))
    return mean, ((x - mean) ** 2).mean(dim=(0, 1, 2))


@pytest.mark.parametrize("activation", ["leaky_relu", "elu", "identity"])
def test_inplace_abn_matches_autodiff_oracle_and_jax(activation):
    """The output-only backward equals autodiff through the batch
    statistics (the reference's edz/eydz formula), and the JAX op."""
    x, w, b, cot = _abn_case(2)
    grads, outs = [], []
    for fn in (A.inplace_abn, A.abn_reference):
        args = [torch.from_numpy(a).requires_grad_() for a in (x, w, b)]
        mean, var = _batch_stats(args[0])
        if fn is A.inplace_abn:
            mean, var = mean.detach(), var.detach()
        y = fn(*args, mean, var, 1e-5, activation, 0.01)
        (y * torch.from_numpy(cot)).sum().backward()
        outs.append(to_np(y))
        grads.append([to_np(a.grad) for a in args])
    np.testing.assert_allclose(outs[0], outs[1], rtol=1e-5, atol=1e-5)
    for gi, gr, what in zip(*grads, ("dx", "dweight", "dbias")):
        np.testing.assert_allclose(gi, gr, rtol=2e-4, atol=2e-4,
                                   err_msg=what)

    def jfn(xx, ww, bb):
        mean = xx.mean(axis=(0, 1, 2))
        var = ((xx - mean) ** 2).mean(axis=(0, 1, 2))
        y = JA.inplace_abn(xx, ww, bb, jax.lax.stop_gradient(mean),
                           jax.lax.stop_gradient(var), 1e-5, activation,
                           0.01)
        return jnp.sum(y * cot), y
    (_, ref), jg = jax.value_and_grad(jfn, argnums=(0, 1, 2), has_aux=True)(
        *map(jnp.asarray, (x, w, b)))
    _assert_close(ref, outs[0], FWD_TOL, "out")
    for g, got, what in zip(jg, grads[0], ("dx", "dweight", "dbias")):
        _assert_close(g, got, GRAD_TOL, what)


def test_inplace_abn_frozen_stats_grad():
    """training=False: dx is the plain affine chain rule."""
    r = np.random.RandomState(7)
    x, w, b, cot = _abn_case(7)
    mean = torch.from_numpy(r.randn(5).astype(np.float32))
    var = torch.from_numpy(r.rand(5).astype(np.float32) + 0.5)
    grads = []
    for fn, extra in ((A.inplace_abn, (False,)), (A.abn_reference, ())):
        args = [torch.from_numpy(a).requires_grad_() for a in (x, w, b)]
        y = fn(*args, mean, var, 1e-5, "leaky_relu", 0.01, *extra)
        (y * torch.from_numpy(cot)).sum().backward()
        grads.append([to_np(a.grad) for a in args])
    for gi, gr, what in zip(*grads, ("dx", "dweight", "dbias")):
        np.testing.assert_allclose(gi, gr, rtol=2e-4, atol=2e-4,
                                   err_msg=what)


def test_inplace_abn_module_running_stats():
    m = A.InPlaceABN(3, momentum=0.5)
    x = torch.from_numpy(np.random.RandomState(3).randn(2, 4, 4, 3)
                         .astype(np.float32) * 2 + 1)
    out = m(x)
    assert out.shape == x.shape
    np.testing.assert_allclose(to_np(m.running_mean),
                               0.5 * to_np(x).mean(axis=(0, 1, 2)),
                               rtol=1e-5, atol=1e-5)
    before = {k: v.clone() for k, v in m.state_dict().items()}
    m.eval()
    m(x)
    for k, v in m.state_dict().items():  # eval does not move them
        assert torch.equal(v, before[k]), k


def test_inplace_abn_saves_no_tensor_of_x():
    """Every tensor autograd saves for the backward: the output and the
    per-channel vectors, none of x's storage (the memory claim)."""
    x = torch.from_numpy(np.random.RandomState(4).randn(2, 8, 8, 4)
                         .astype(np.float32)).requires_grad_()
    w = torch.ones(4, requires_grad=True)
    b = torch.zeros(4, requires_grad=True)
    mean, var = torch.zeros(4), torch.ones(4)
    saved = []

    def pack(t):
        saved.append(t)
        return t
    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        out = A.inplace_abn(x, w, b, mean, var)
    assert saved and not any(
        t.untyped_storage().data_ptr() == x.untyped_storage().data_ptr()
        for t in saved)
    assert sum(t.shape == x.shape for t in saved) == 1
    assert any(t.data_ptr() == out.data_ptr() for t in saved)
    # the plain oracle keeps more than the output alive
    saved.clear()
    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        A.abn_reference(x, w, b, mean, var)
    assert sum(t.shape == x.shape for t in saved) > 1


# -- deformable PS-ROI pooling ------------------------------------------------

@pytest.mark.parametrize("with_trans", [False, True],
                         ids=["no_trans", "trans"])
def test_psroi_pooling_matches_jax(with_trans):
    r = np.random.RandomState(8)
    d, gs, p, part = 3, 2, 4, 2
    x = r.randn(2, 10, 12, d * gs * gs).astype(np.float32)
    rois = np.array([[0, 10.0, 8.0, 120.0, 100.0],
                     [1, -20.0, 30.0, 60.0, 200.0],
                     [1, 50.0, 40.0, 55.0, 48.0]], np.float32)
    trans = (r.randn(3, part, part, 2 * d) * 0.5).astype(np.float32) \
        if with_trans else None
    cot = r.randn(3, p, p, d).astype(np.float32)
    kw = dict(output_dim=d, pooled_size=p, group_size=gs, part_size=part,
              sample_per_part=3, spatial_scale=1.0 / 8, trans_std=0.2)

    def jfn(xx, tt):
        y = j_psroi(xx, jnp.asarray(rois), tt, **kw)
        return jnp.sum(y * cot), y
    jt = None if trans is None else jnp.asarray(trans)
    argnums = (0, 1) if with_trans else (0,)
    (_, ref), jg = jax.value_and_grad(jfn, argnums=argnums, has_aux=True)(
        jnp.asarray(x), jt)
    xt = torch.from_numpy(x).requires_grad_()
    tt = None if trans is None else torch.from_numpy(trans).requires_grad_()
    y = deform_psroi_pooling(xt, torch.from_numpy(rois), tt, **kw)
    (y * torch.from_numpy(cot)).sum().backward()
    _assert_close(ref, to_np(y), FWD_TOL, "out")
    _assert_close(jg[0], to_np(xt.grad), GRAD_TOL, "data")
    if with_trans:
        _assert_close(jg[1], to_np(tt.grad), GRAD_TOL, "trans")


def test_psroi_pooling_uniform_input():
    """A constant channel: every bin pools its position-sensitive
    channel's value."""
    c_out, gs = 2, 2
    data = torch.zeros(1, 16, 16, c_out * gs * gs)
    for ci in range(data.shape[-1]):
        data[..., ci] = ci + 1.0
    out = deform_psroi_pooling(data, torch.tensor([[0, 0.0, 0.0, 200.0,
                                                     200.0]]),
                               None, output_dim=c_out, pooled_size=4,
                               group_size=gs, spatial_scale=1.0 / 16)
    assert tuple(out.shape) == (1, 4, 4, c_out)
    assert float(out[0, 0, 0, 0]) == pytest.approx(1.0, rel=1e-5)
    assert float(out[0, 3, 3, 0]) == pytest.approx(4.0, rel=1e-5)
    assert float(out[0, 0, 0, 1]) == pytest.approx(5.0, rel=1e-5)
