"""The port's co-designed deform conv against the JAX package.

The CPU route of `codesign_deform_conv_fast` (the plain PyTorch version)
is held against the Pallas forward kernel, which runs in interpret mode on
the CPU as tests/test_deform_pallas.py runs it; the plain general
`codesign_deform_conv` against the JAX XLA formulation and the numpy
oracle; `CodesignDeformBlock` against the JAX block. The CUDA kernel
itself is checked against the plain version on a card, in
tests/test_torch_cuda.py.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from test_torch_common import (deform_case, hwio_to_oihw, nchw_to_nhwc,
                               nhwc_to_nchw, rng, to_np)

from codenet_tpu.ops import deform_pallas as DP
from codenet_tpu.ops import deform_conv as JDC
from codenet_torch.ops import deform_conv as TDC
from codenet_torch.ops import deform_cuda as DC


# tests/test_deform_pallas.py:29-30 shapes, plus odd C
@pytest.mark.parametrize("shape", [(8, 8, 256), (16, 8, 128), (12, 12, 64),
                                   (24, 24, 32), (12, 12, 58)])
def test_fast_cpu_matches_pallas_f32(shape):
    x, s, w = deform_case(shape)
    ref = np.asarray(DP.codesign_deform_conv_fast(
        jnp.asarray(x), jnp.asarray(s), jnp.asarray(w)))
    out = DC.codesign_deform_conv_fast(torch.from_numpy(x),
                                       torch.from_numpy(s),
                                       torch.from_numpy(w))
    assert out.dtype == torch.float32 and out.shape == x.shape
    np.testing.assert_allclose(to_np(out), ref, rtol=2e-3, atol=2e-3)


@pytest.mark.parametrize("shape", [(8, 8, 128), (12, 12, 58)])
def test_fast_cpu_matches_pallas_bf16(shape):
    x, s, w = deform_case(shape, seed=2)
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    wb = jnp.asarray(w).astype(jnp.bfloat16)
    ref = np.asarray(DP.codesign_deform_conv_fast(xb, jnp.asarray(s), wb)
                     .astype(jnp.float32))
    out = DC.codesign_deform_conv_fast(
        torch.from_numpy(np.array(xb.astype(jnp.float32))).bfloat16(),
        torch.from_numpy(s),
        torch.from_numpy(np.array(wb.astype(jnp.float32))).bfloat16())
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(to_np(out), ref, rtol=3e-2, atol=3e-2)


def test_plain_clamps_s_at_op_boundary():
    """s beyond [-7, 8] samples exactly like the clamped s (the op
    contract of deform_pallas.py:541-555)."""
    x, s, w = deform_case((10, 10, 8), seed=3, s_range=(-20.0, 20.0))
    a = DC.codesign_deform_conv_plain(torch.from_numpy(x),
                                      torch.from_numpy(s),
                                      torch.from_numpy(w))
    b = DC.codesign_deform_conv_plain(torch.from_numpy(x),
                                      torch.from_numpy(np.clip(s, -7, 8)),
                                      torch.from_numpy(w))
    assert torch.equal(a, b)


@pytest.mark.parametrize("stride", [1, 2])
def test_plain_codesign_matches_xla(stride):
    x, s, w = deform_case((9, 11, 16), seed=4, s_range=(-2.0, 3.0))
    ho, wo = (9, 11) if stride == 1 else (5, 6)
    s = s[:, :ho, :wo]
    ref = np.asarray(JDC.codesign_deform_conv(
        jnp.asarray(x), jnp.asarray(s), jnp.asarray(w), stride=stride,
        precision=jax.lax.Precision.HIGHEST))
    out = TDC.codesign_deform_conv(torch.from_numpy(x), torch.from_numpy(s),
                                   torch.from_numpy(w), stride=stride)
    np.testing.assert_allclose(to_np(out), ref, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("groups", [None, 1])
def test_plain_codesign_matches_naive(groups):
    """Tiny case against the numpy loop oracle, with the co-design offsets
    written out in the reference offset layout."""
    r = rng(5)
    n, h, w, c = 1, 5, 4, 3
    x = r.randn(n, h, w, c).astype(np.float32)
    s = r.uniform(-2.0, 3.0, (n, h, w, 1)).astype(np.float32)
    cout = c if groups is None else 2
    cpg = 1 if groups is None else c
    wt = r.randn(3, 3, cpg, cout).astype(np.float32)
    offset = (TDC.ANCHOR_OFFSETS[None, None, None]
              * (s[..., None] - 1.0)).reshape(n, h, w, 18)
    ref = TDC.deform_conv2d_naive(x, offset, wt, groups=groups or c)
    out = TDC.codesign_deform_conv(torch.from_numpy(x), torch.from_numpy(s),
                                   torch.from_numpy(wt), groups=groups)
    np.testing.assert_allclose(to_np(out), ref, rtol=1e-5, atol=1e-5)


def test_naive_oracles_agree():
    """The port's numpy oracle is the JAX package's, number for number."""
    r = rng(6)
    x = r.randn(1, 4, 5, 2)
    off = r.randn(1, 4, 5, 18) * 2
    wt = r.randn(3, 3, 2, 3)
    np.testing.assert_array_equal(TDC.deform_conv2d_naive(x, off, wt),
                                  JDC.deform_conv2d_naive(x, off, wt))


def test_plain_backpropagates_on_cpu():
    """The CPU route is plain autograd (the kernel route is forward-only)."""
    x, s, w = deform_case((6, 6, 4), seed=7, s_range=(-2.0, 3.0))
    xt = torch.from_numpy(x).requires_grad_()
    st = torch.from_numpy(s).requires_grad_()
    DC.codesign_deform_conv_fast(xt, st, torch.from_numpy(w)).sum().backward()
    assert torch.isfinite(xt.grad).all() and torch.isfinite(st.grad).all()


def test_kernel_wrapper_checks():
    """Argument checks of the CUDA route (the logic runs on any device)."""
    x, s, w = (torch.from_numpy(a) for a in deform_case((4, 4, 8)))
    with pytest.raises(ValueError):
        DC._check(x, s[:, :3], w)
    with pytest.raises(ValueError):
        DC._check(x, s, w[..., :4])
    with pytest.raises(TypeError):
        DC._check(x.double(), s, w)
    with pytest.raises(TypeError):
        DC._check(x, s.double(), w)
    with pytest.raises(ValueError):
        DC._check(x.transpose(1, 2), s, w)
    with pytest.raises(NotImplementedError, match="training slice"):
        DC._check(x, s, w.clone().requires_grad_())
    with torch.no_grad():
        DC._check(x, s, w.clone().requires_grad_())


@pytest.mark.parametrize("stride", [1, 2])
def test_block_matches_jax(stride, monkeypatch):
    """JAX CodesignDeformBlock (reaching the Pallas kernel at stride 1)
    == the port's block followed by the deconv stage's BatchNorm."""
    monkeypatch.setenv("CODENET_PALLAS_INTERPRET", "1")
    from codenet_tpu.models.layers import CodesignDeformBlock as JBlock
    from codenet_torch.models.layers import CodesignDeformBlock as TBlock

    r = rng(8)
    cin, cout = 24, 16
    x = np.maximum(r.randn(2, 8, 8, cin), 0).astype(np.float32)
    blk = JBlock(cout, stride=stride)
    variables = jax.jit(blk.init)(jax.random.PRNGKey(0), jnp.asarray(x))
    p = jax.tree_util.tree_map(np.asarray, dict(variables["params"]))
    st = jax.tree_util.tree_map(np.asarray, dict(variables["batch_stats"]))
    p["conv_scale"]["kernel"] = (r.randn(1, 1, cin, 1) * 0.8).astype(
        np.float32)
    p["conv_scale"]["bias"] = np.array([0.5], np.float32)
    cc = p["conv_channel"]
    cc["scale"] = r.uniform(0.5, 1.5, cout).astype(np.float32)
    cc["bias"] = (r.randn(cout) * 0.1).astype(np.float32)
    st["conv_channel"]["mean"] = (r.randn(cout) * 0.1).astype(np.float32)
    st["conv_channel"]["var"] = r.uniform(0.5, 1.5, cout).astype(np.float32)
    ref = np.asarray(jax.jit(blk.apply)(
        {"params": p, "batch_stats": st}, jnp.asarray(x)))

    tb = TBlock(cin, cout, stride=stride)
    bn = torch.nn.BatchNorm2d(cout)
    with torch.no_grad():
        tb.conv_scale.weight.copy_(torch.from_numpy(
            hwio_to_oihw(p["conv_scale"]["kernel"])))
        tb.conv_scale.bias.copy_(torch.from_numpy(p["conv_scale"]["bias"]))
        tb.conv.weight.copy_(torch.from_numpy(
            hwio_to_oihw(p["deform_kernel"])))
        tb.conv_channel.weight.copy_(torch.from_numpy(
            hwio_to_oihw(cc["kernel"])))
        bn.weight.copy_(torch.from_numpy(cc["scale"]))
        bn.bias.copy_(torch.from_numpy(cc["bias"]))
        bn.running_mean.copy_(torch.from_numpy(st["conv_channel"]["mean"]))
        bn.running_var.copy_(torch.from_numpy(st["conv_channel"]["var"]))
    tb.eval()
    bn.eval()
    xt = torch.from_numpy(nhwc_to_nchw(x)).contiguous(
        memory_format=torch.channels_last)
    with torch.no_grad():
        out = bn(tb(xt))
    np.testing.assert_allclose(nchw_to_nhwc(to_np(out)), ref, rtol=2e-3,
                               atol=2e-3)
