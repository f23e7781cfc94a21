"""The general deformable conv (`ops/deform_conv.py::deform_conv2d`) and
DCNv2 (`models/deform_modules.py::ModulatedDeformConvPack`) of the port
against the JAX package, on seeded numpy inputs.

- `deform_conv2d` forward within 2e-3 of the output's max and its
  gradients (x, offset, weight, mask) within 5e-3 of each one's max,
  over groups {1, 2}, deformable groups {1, 2}, mask {none, given} and
  stride {1, 2}, with offsets of up to 2.5 px that leave the map;
- the same op against the numpy loop reference `deform_conv2d_naive` (no
  mask), 1e-5;
- `ModulatedDeformConvPack` with non-zero carried offsets and mask: its
  output and the gradients of its input and parameters against the JAX
  module's on the same weights (2e-3 / 5e-3), and the tap interleave
  (o1[t], o2[t]) checked against the op with the offsets laid out by
  hand.
"""

import itertools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from test_torch_common import nchw_to_nhwc, nhwc_to_nchw, rng, to_np

from codenet_tpu.models import deform_modules as JDM
from codenet_tpu.ops import deform_conv as JDC
from codenet_torch.models.deform_modules import ModulatedDeformConvPack
from codenet_torch.ops import deform_conv as TDC

FWD_TOL = 2e-3
GRAD_TOL = 5e-3


def _case(seed, groups, dg, masked, stride, n=2, h=7, w=6, c=4, cout=4):
    r = rng(seed)
    ho = (h + 2 - 3) // stride + 1
    wo = (w + 2 - 3) // stride + 1
    x = r.randn(n, h, w, c).astype(np.float32)
    off = r.uniform(-2.5, 2.5, (n, ho, wo, dg * 18)).astype(np.float32)
    wt = (r.randn(3, 3, c // groups, cout) * 0.3).astype(np.float32)
    mask = r.rand(n, ho, wo, dg * 9).astype(np.float32) if masked else None
    return x, off, wt, mask


def _assert_close(ref, got, tol, what):
    ref, got = np.asarray(ref), np.asarray(got)
    assert ref.shape == got.shape, (what, ref.shape, got.shape)
    scale = float(np.abs(ref).max())
    err = float(np.abs(ref - got).max())
    assert err <= tol * scale, (what, err, scale)


@pytest.mark.parametrize("groups,dg,masked,stride", list(itertools.product(
    (1, 2), (1, 2), (False, True), (1, 2))))
def test_deform_conv2d_matches_jax(groups, dg, masked, stride):
    x, off, wt, mask = _case(10 + 8 * groups + 4 * dg + 2 * masked + stride,
                             groups, dg, masked, stride)
    cot = rng(5).randn(*JDC.deform_conv2d(
        jnp.asarray(x), jnp.asarray(off), jnp.asarray(wt), stride=stride,
        groups=groups, deformable_groups=dg).shape).astype(np.float32)

    def jfn(*args):
        m = args[3] if masked else None
        y = JDC.deform_conv2d(args[0], args[1], args[2], stride=stride,
                              groups=groups, deformable_groups=dg, mask=m)
        return jnp.sum(y * cot), y

    ins = [x, off, wt] + ([mask] if masked else [])
    (_, ref), grads = jax.value_and_grad(
        jfn, argnums=tuple(range(len(ins))), has_aux=True)(
            *map(jnp.asarray, ins))
    tins = [torch.from_numpy(a).requires_grad_() for a in ins]
    y = TDC.deform_conv2d(tins[0], tins[1], tins[2], stride=stride,
                          groups=groups, deformable_groups=dg,
                          mask=tins[3] if masked else None)
    (y * torch.from_numpy(cot)).sum().backward()
    _assert_close(ref, to_np(y), FWD_TOL, "out")
    for name, g, t in zip(("x", "offset", "weight", "mask"), grads, tins):
        _assert_close(g, to_np(t.grad), GRAD_TOL, name)


@pytest.mark.parametrize("groups,dg,stride", [(1, 1, 1), (2, 2, 1),
                                              (1, 2, 2)])
def test_deform_conv2d_matches_naive(groups, dg, stride):
    x, off, wt, _ = _case(40 + groups + dg + stride, groups, dg, False,
                          stride, n=1, h=5, w=5)
    ref = TDC.deform_conv2d_naive(x, off, wt, stride, 1, 1, groups, dg)
    got = TDC.deform_conv2d(torch.from_numpy(x), torch.from_numpy(off),
                            torch.from_numpy(wt), stride=stride,
                            groups=groups, deformable_groups=dg)
    np.testing.assert_allclose(to_np(got), ref, rtol=0, atol=1e-5)


def _dcn_pair(seed, cin=6, cout=5):
    """A port DCN with seeded non-zero conv_offset_mask (offsets of a few
    px, partly off the 8x8 map) and bias, and its flax params."""
    r = rng(seed)
    mod = ModulatedDeformConvPack(cin, cout)
    mod.reset_parameters(torch.Generator().manual_seed(seed))
    with torch.no_grad():
        mod.conv_offset_mask.weight.copy_(torch.from_numpy(
            (r.randn(27, cin, 3, 3) * 0.4).astype(np.float32)))
        mod.conv_offset_mask.bias.copy_(torch.from_numpy(
            r.randn(27).astype(np.float32)))
        mod.bias.copy_(torch.from_numpy(r.randn(cout).astype(np.float32)))
    params = {"conv_offset_mask": {
        "kernel": np.transpose(to_np(mod.conv_offset_mask.weight),
                               (2, 3, 1, 0)),
        "bias": to_np(mod.conv_offset_mask.bias)},
        "weight": np.transpose(to_np(mod.weight), (2, 3, 1, 0)),
        "bias": to_np(mod.bias)}
    return mod, params


def test_modulated_deform_conv_pack_matches_jax():
    mod, params = _dcn_pair(3)
    x = rng(4).randn(2, 8, 8, 6).astype(np.float32)
    cot = rng(6).randn(2, 8, 8, 5).astype(np.float32)
    jmod = JDM.ModulatedDeformConvPack(5)

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
    _assert_close(gp["weight"], np.transpose(to_np(mod.weight.grad),
                                             (2, 3, 1, 0)), GRAD_TOL, "w")
    _assert_close(gp["bias"], to_np(mod.bias.grad), GRAD_TOL, "bias")
    _assert_close(gp["conv_offset_mask"]["kernel"],
                  np.transpose(to_np(mod.conv_offset_mask.weight.grad),
                               (2, 3, 1, 0)), GRAD_TOL, "offset kernel")
    _assert_close(gp["conv_offset_mask"]["bias"],
                  to_np(mod.conv_offset_mask.bias.grad), GRAD_TOL,
                  "offset bias")


def test_modulated_deform_conv_pack_interleaves_taps():
    """Tap t reads (o1[t], o2[t]) of conv_offset_mask's output, as the JAX
    package builds the offset; DCNv2's cat((o1, o2)) layout (tap t from
    channels 2t, 2t + 1) gives another output."""
    mod, _ = _dcn_pair(7)
    x = torch.from_numpy(nhwc_to_nchw(rng(8).randn(1, 8, 8, 6).astype(
        np.float32)))
    with torch.no_grad():
        om = to_np(mod.conv_offset_mask(x)).transpose(0, 2, 3, 1)
        o1, o2, m = om[..., :9], om[..., 9:18], om[..., 18:]
        mask = torch.from_numpy(1 / (1 + np.exp(-m)))
        w = mod.weight.permute(2, 3, 1, 0)

        def run(offset):
            y = TDC.deform_conv2d(x.permute(0, 2, 3, 1),
                                  torch.from_numpy(offset), w, mask=mask)
            return to_np(y + mod.bias)

        inter = np.stack([o1, o2], -1).reshape(1, 8, 8, 18)
        concat = np.concatenate([o1, o2], -1)
        got = nchw_to_nhwc(to_np(mod(x)))
    np.testing.assert_allclose(got, run(inter), rtol=0, atol=1e-5)
    assert np.abs(got - run(concat)).max() > 1e-2
