"""The port's co-designed deform conv against the JAX package.

The CPU route of `codesign_deform_conv_fast` (the plain PyTorch versions,
forward and backward) is held against the Pallas kernels, which run in
interpret mode on the CPU as tests/test_deform_pallas.py runs them; the
plain general `codesign_deform_conv` against the JAX XLA formulation and
the numpy oracle; `CodesignDeformBlock` against the JAX block, forward and
train-mode gradients. The CUDA kernels themselves are checked against the
plain versions on a card, in tests/test_torch_cuda.py.
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
    """The CPU route's backward is the plain backward, which agrees with
    autograd through the plain forward where s is inside (-7, 8)."""
    x, s, w = deform_case((6, 6, 4), seed=7, s_range=(-2.0, 3.0))
    xt = torch.from_numpy(x).requires_grad_()
    st = torch.from_numpy(s).requires_grad_()
    DC.codesign_deform_conv_fast(xt, st, torch.from_numpy(w)).sum().backward()
    assert torch.isfinite(xt.grad).all() and torch.isfinite(st.grad).all()
    xa = torch.from_numpy(x).requires_grad_()
    sa = torch.from_numpy(s).requires_grad_()
    DC.codesign_deform_conv_plain(xa, sa, torch.from_numpy(w)).sum().backward()
    torch.testing.assert_close(xt.grad, xa.grad, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(st.grad, sa.grad, rtol=1e-5, atol=1e-5)


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
    DC._check(x, s, w.clone().requires_grad_())
    with pytest.raises(ValueError):
        DC._launch_bwd(x, s, w, x[:, :2])


def test_fwd_args_take_the_weight_view():
    """The forward kernel gets the model's permuted OIHW weight (the deform
    block's `weight.permute(2, 3, 1, 0)`) as it is: its own address and
    (tap, channel) strides (1, 9), no copy. A bf16 weight is cast to f32;
    a contiguous HWIO weight goes in with strides (C, 1)."""
    x, s, _ = (torch.from_numpy(a) for a in deform_case((4, 4, 8)))
    out = torch.empty_like(x)
    plan = DC.fwd_plan(2, 4, 4, 8, x.dtype)
    oihw = torch.randn(8, 1, 3, 3)
    args, w_kc = DC._fwd_args(x, s, oihw.permute(2, 3, 1, 0), out, plan)
    assert w_kc.data_ptr() == args[2] == oihw.data_ptr()
    assert args[9:11] == (1, 9)
    assert args[:2] == (x.data_ptr(), s.data_ptr())
    assert args[3:9] == (out.data_ptr(), 2, 4, 4, 8, 0)
    assert args[11:] == (plan["rows"], plan["cb"], plan["vec"],
                         plan["threads"], plan["smem_bytes"])
    # the kernel reads w[t, c] at t * args[9] + c * args[10]
    flat = oihw.reshape(-1)
    for t in range(9):
        for c in range(8):
            assert flat[t * args[9] + c * args[10]] == oihw[c, 0, t // 3,
                                                           t % 3]
    args, w_kc = DC._fwd_args(x, s, oihw.permute(2, 3, 1, 0).bfloat16(),
                              out, plan)
    assert w_kc.dtype == torch.float32 and args[2] == w_kc.data_ptr()
    hwio = oihw.permute(2, 3, 1, 0).contiguous()
    args, _ = DC._fwd_args(x, s, hwio, out, plan)
    assert args[2] == hwio.data_ptr() and args[9:11] == (8, 1)


def test_fwd_alignment_narrows_the_vector():
    """An x whose address is 4 or 8 bytes past a 16-byte boundary takes
    the kernel's narrow vectors; C that 4 (f32) or 8 (bf16) does not
    divide does too."""
    buf = torch.zeros(2 * 8 * 8 * 32 + 4)
    assert DC._alignment(buf) == 16
    assert DC._alignment(buf[1:], buf) == 4
    assert DC._alignment(buf[2:]) == 8
    assert DC.fwd_plan(2, 8, 8, 32, torch.float32, align=4)["vec"] == 1
    assert DC.fwd_plan(2, 8, 8, 32, torch.float32, align=8)["vec"] == 2
    assert DC.fwd_plan(2, 8, 8, 32, torch.bfloat16, align=4)["vec"] == 2
    assert DC.fwd_plan(2, 8, 8, 58, torch.float32)["vec"] == 2
    assert DC.fwd_plan(2, 8, 8, 36, torch.bfloat16)["vec"] == 4
    assert DC.fwd_plan(2, 8, 8, 2153, torch.bfloat16)["vec"] == 1


@pytest.mark.parametrize("stride", [1, 2])
def test_block_matches_jax(stride, monkeypatch):
    """JAX CodesignDeformBlock (reaching the Pallas kernel at stride 1)
    == the port's block with the deconv stage's BatchNorm passed in."""
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
        out = tb(xt, bn)
    np.testing.assert_allclose(nchw_to_nhwc(to_np(out)), ref, rtol=2e-3,
                               atol=2e-3)


# -- backward ---------------------------------------------------------------

def _s_case(name, shape, seed):
    """s of one kind: fractional (crossing the clamp and the map), all
    ones (the scale predictor's init), integers, exactly -7 / 8 mixed with
    values inside, or out of contract (beyond the clamp on both sides)."""
    r = rng(seed)
    size = (2,) + tuple(shape[:2]) + (1,)
    s = {"fractional": lambda: r.uniform(-9.0, 10.0, size),
         "ones": lambda: np.ones(size),
         "integer": lambda: r.randint(-8, 10, size),
         "bounds": lambda: r.choice([-7.0, 8.0, -6.5, 0.25, 7.5], size),
         "out_of_contract": lambda: r.choice([-30.0, -7.5, 8.5, 30.0, 2.5],
                                             size)}[name]()
    return s.astype(np.float32)


def _grads(x, s, w, g, dtype=torch.float32):
    """(dx, ds, dw) of the JAX Pallas op (interpret mode) and of the
    port's CPU route, as f32 numpy."""
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    xj, wj, gj = (jnp.asarray(a).astype(jdt) for a in (x, w, g))
    _, vjp = jax.vjp(DP.codesign_deform_conv_fast, xj, jnp.asarray(s), wj)
    ref = [np.asarray(a.astype(jnp.float32)) for a in vjp(gj)]
    xt, wt, gt = (torch.from_numpy(np.array(a.astype(jnp.float32)))
                  .to(dtype) for a in (xj, wj, gj))
    xt.requires_grad_()
    wt.requires_grad_()
    st = torch.from_numpy(s).requires_grad_()
    out = DC.codesign_deform_conv_fast(xt, st, wt)
    assert out.dtype == dtype
    out.backward(gt)
    assert xt.grad.dtype == dtype and wt.grad.dtype == dtype
    assert st.grad.dtype == torch.float32
    return ref, [to_np(a.grad) for a in (xt, st, wt)]


def _assert_grads_close(ref, out, rel):
    for name, a, b in zip(("dx", "ds", "dw"), ref, out):
        assert a.shape == b.shape, name
        scale = float(np.abs(a).max())
        err = float(np.abs(a - b).max())
        assert err <= rel * scale, (name, err, scale)


@pytest.mark.parametrize("shape", [(8, 8, 256), (16, 8, 128), (12, 12, 64),
                                   (24, 24, 32), (12, 12, 58)])
def test_fast_cpu_grads_match_pallas_f32(shape):
    x, _, w = deform_case(shape, seed=30)
    s = _s_case("fractional", shape, 31)
    g = rng(32).randn(*x.shape).astype(np.float32)
    _assert_grads_close(*_grads(x, s, w, g), rel=5e-3)


@pytest.mark.parametrize("s_kind", ["ones", "integer", "bounds",
                                    "out_of_contract"])
def test_fast_cpu_grads_match_pallas_s_kinds(s_kind):
    """Integer coordinates give the one-sided d/ds towards floor + 1 in
    both; ds is exactly 0 at s == -7, s == 8 and beyond the clamp."""
    shape = (8, 8, 32)
    x, _, w = deform_case(shape, seed=33)
    s = _s_case(s_kind, shape, 34)
    g = rng(35).randn(*x.shape).astype(np.float32)
    ref, out = _grads(x, s, w, g)
    _assert_grads_close(ref, out, rel=5e-3)
    outside = (s <= -7.0) | (s >= 8.0)
    if outside.any():
        assert np.abs(out[1][outside]).max() == 0.0
        assert np.abs(ref[1][outside]).max() == 0.0


@pytest.mark.parametrize("shape", [(8, 8, 128), (12, 12, 58)])
def test_fast_cpu_grads_match_pallas_bf16(shape):
    """bf16 inputs: the Pallas kernel rounds the bilinear weights and g to
    bf16 before its f32 dots, the port computes in f32 from the same bf16
    inputs; they agree within bf16 resolution (3e-2 of each max)."""
    x, _, w = deform_case(shape, seed=36)
    s = _s_case("fractional", shape, 37)
    g = rng(38).randn(*x.shape).astype(np.float32)
    _assert_grads_close(*_grads(x, s, w, g, torch.bfloat16), rel=3e-2)


def test_block_train_grads_match_jax(monkeypatch):
    """JAX CodesignDeformBlock in train mode (BN on batch statistics,
    Pallas forward and backward in interpret mode) == the port's block +
    the deconv stage's BatchNorm in train mode: loss, every parameter's
    gradient, the input gradient and the updated running statistics."""
    monkeypatch.setenv("CODENET_PALLAS_INTERPRET", "1")
    from codenet_tpu.models.layers import CodesignDeformBlock as JBlock
    from codenet_torch.models.layers import CodesignDeformBlock as TBlock

    r = rng(39)
    cin, cout = 24, 16
    x = np.maximum(r.randn(2, 8, 8, cin), 0).astype(np.float32)
    probe = r.randn(2, 8, 8, cout).astype(np.float32)
    blk = JBlock(cout)
    variables = jax.jit(blk.init)(jax.random.PRNGKey(1), jnp.asarray(x))
    p = jax.tree_util.tree_map(np.asarray, dict(variables["params"]))
    st = jax.tree_util.tree_map(np.asarray, dict(variables["batch_stats"]))
    p["conv_scale"]["kernel"] = (r.randn(1, 1, cin, 1) * 0.8).astype(
        np.float32)
    p["conv_scale"]["bias"] = np.array([0.5], np.float32)

    def jloss(params, xin):
        y, upd = blk.apply({"params": params, "batch_stats": st}, xin,
                           train=True, mutable=["batch_stats"])
        return jnp.sum(y * probe), upd

    (lref, upd), (gp, gx) = jax.value_and_grad(jloss, argnums=(0, 1),
                                               has_aux=True)(
        p, jnp.asarray(x))

    tb = TBlock(cin, cout)
    bn = torch.nn.BatchNorm2d(cout)
    cc = p["conv_channel"]
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
    tb.train()
    bn.train()
    xt = torch.from_numpy(nhwc_to_nchw(x)).contiguous(
        memory_format=torch.channels_last).requires_grad_()
    y = tb(xt, bn)
    loss = (y * torch.from_numpy(nhwc_to_nchw(probe))).sum()
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(lref),
                               rtol=1e-4)
    pairs = [(tb.conv_scale.weight.grad, gp["conv_scale"]["kernel"]),
             (tb.conv_scale.bias.grad, gp["conv_scale"]["bias"]),
             (tb.conv.weight.grad, gp["deform_kernel"]),
             (tb.conv_channel.weight.grad, gp["conv_channel"]["kernel"]),
             (bn.weight.grad, gp["conv_channel"]["scale"]),
             (bn.bias.grad, gp["conv_channel"]["bias"]),
             (xt.grad, gx)]
    for got, ref in pairs:
        ref = np.asarray(ref)
        if ref.ndim == 4 and got.dim() == 4 and got.shape[0] == 2:
            got = nchw_to_nhwc(to_np(got))
        elif ref.ndim == 4:
            got = np.transpose(to_np(got), (2, 3, 1, 0))
        else:
            got = to_np(got)
        assert got.shape == ref.shape
        scale = float(np.abs(ref).max())
        assert float(np.abs(got - ref).max()) <= 5e-3 * scale
    new = upd["batch_stats"]["conv_channel"]
    np.testing.assert_allclose(to_np(bn.running_mean), new["mean"],
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(to_np(bn.running_var), new["var"],
                               rtol=1e-4, atol=1e-5)


# -- backward launch plan ---------------------------------------------------

# (H, W, C) and the slice width cb at batch 32: chip_smoke.py's backward
# shapes (the model's three, the ragged ones, KITTI's 48x160, the deform
# backbone's three), a 64x64 map whose tile allows less than 32 channels;
# None: a map past one block
@pytest.mark.parametrize("shape,cb_at_32", [
    ((8, 8, 1024), 256), ((16, 16, 256), 64), ((32, 32, 128), 32),
    ((12, 12, 58), 16), ((16, 16, 2153), 128), ((24, 24, 32), 8),
    ((48, 160, 64), 4), ((64, 64, 64), 8), ((32, 32, 58), 16),
    ((16, 16, 116), 32), ((8, 8, 232), 64), ((256, 256, 8), None)])
def test_bwd_plan(shape, cb_at_32):
    """The backward kernel's launch plan: the dx tile and geometry fit a
    block's 232,448 bytes; the slices cover C, the last one partly; cb is
    the largest power of two that fits, halved (not below 8) only while
    the grid has fewer than 132 blocks and the halved one no more; the
    threads tile the slice and divide the geometry group, 1024 where an
    SM holds one block only."""
    h, w, c = shape
    if cb_at_32 is None:
        with pytest.raises(ValueError):
            DC.bwd_plan(32, h, w, c)
        return
    hw = h * w
    fits = lambda k: DC._bwd_smem_bytes(hw, k) <= 232_448  # noqa: E731
    for n in (1, 2, 32, 128):
        plan = DC.bwd_plan(n, h, w, c)
        cb, threads, slices = plan["cb"], plan["threads"], plan["slices"]
        assert cb & (cb - 1) == 0 and 1 <= cb <= 256
        assert hw * cb * 4 < plan["smem_bytes"] <= 232_448
        assert plan["smem_bytes"] == DC._bwd_smem_bytes(hw, cb)
        assert (slices - 1) * cb < c <= slices * cb
        assert plan["blocks"] == n * slices
        assert threads % 32 == 0 and threads % cb == 0
        assert 64 % (threads // cb) == 0
        alone = (plan["blocks"] <= 132
                 or 2 * (plan["smem_bytes"] + 1024) > 233_472)
        assert threads == min(1024 if alone else 512, 64 * cb)
        if c >= 8 and fits(8):
            assert cb >= 8
        # halved only to fill the card, never below 8 or past its SMs
        assert cb <= 8 or plan["blocks"] >= 132 \
            or n * -(-c // (cb // 2)) > 132
        # twice cb was refused: past 256 or c, too large, or too few blocks
        up = 2 * cb
        assert (up > min(256, 1 << (c - 1).bit_length()) or not fits(up)
                or n * -(-c // up) < 132)
    assert DC.bwd_plan(32, h, w, c)["cb"] == cb_at_32


# -- forward launch plan ----------------------------------------------------

_F32, _BF16 = torch.float32, torch.bfloat16
# (rows, cb, vec, threads, blocks) at batches 2 and 32 for the model's
# three shapes: at 2, slices of 128 bytes or less and short bands make one
# wave of 128 blocks, the slice narrowed before a band would restage more
# than FWD_MAX_RESTAGE input rows per row (32x32 at 4 rows of 16
# channels); at 32, 128-byte slices or wider, banded at 32x32 so that two
# blocks fit an SM
_FWD_MODEL_PLANS = {
    (8, 8, 1024): {(2, _F32): (4, 32, 4, 256, 128),
                   (32, _F32): (8, 256, 4, 256, 128),
                   (2, _BF16): (2, 64, 8, 256, 128),
                   (32, _BF16): (8, 256, 8, 256, 128)},
    (16, 16, 256): {(2, _F32): (2, 32, 4, 256, 128),
                    (32, _F32): (16, 64, 4, 256, 128),
                    (2, _BF16): (2, 32, 8, 256, 128),
                    (32, _BF16): (16, 64, 8, 256, 128)},
    (32, 32, 128): {(2, _F32): (4, 16, 4, 256, 128),
                    (32, _F32): (8, 32, 4, 256, 512),
                    (2, _BF16): (4, 16, 8, 256, 128),
                    (32, _BF16): (8, 64, 8, 256, 256)},
}


# the model's three shapes, the ragged ones, KITTI's 48x160 (bands clip at
# both edges), and a map too wide for one block (None)
@pytest.mark.parametrize("shape,plans", [
    (shape, plans) for shape, plans in _FWD_MODEL_PLANS.items()] + [
    ((12, 12, 58), {}), ((16, 16, 2153), {}), ((24, 24, 32), {}),
    ((48, 160, 64), {}), ((64, 512, 64), None)])
def test_fwd_plan(shape, plans):
    """The forward kernel's launch plan: the tile fits a block's 232,448
    bytes, two blocks to an SM where a 128-byte slice of one row allows
    it; the slices and bands cover C and H, the last ones partly; vec
    divides C and is 16 bytes where C allows; cb is a power of two of at
    least 32 bytes, and 128 bytes or more wherever the grid was not split
    below it; the threads are a multiple of 32 and of the vectors of a
    slice, with at most 128 position lanes, 512 where one block fills an
    SM's shared memory; the grid holds at least half as many blocks as
    the card has SMs unless slice and band are at their narrowest; the
    exact plan at batches 2 and 32 for the model's shapes."""
    h, w, c = shape
    for dtype in (_F32, _BF16):
        esize = 4 if dtype == _F32 else 2
        if plans is None:
            with pytest.raises(ValueError):
                DC.fwd_plan(2, h, w, c, dtype)
            continue
        for n in (1, 2, 32, 128):
            plan = DC.fwd_plan(n, h, w, c, dtype)
            rows, cb, vec = plan["rows"], plan["cb"], plan["vec"]
            assert plan["smem_bytes"] == DC._fwd_smem_bytes(h, w, rows, cb,
                                                            esize)
            assert plan["smem_bytes"] <= 232_448
            tile_rows = min(h, rows + 17)
            assert plan["smem_bytes"] == 128 * 6 * 16 + tile_rows * w * cb \
                * esize
            assert 1 <= rows <= h
            assert (plan["bands"] - 1) * rows < h <= plan["bands"] * rows
            assert (plan["slices"] - 1) * cb < c <= plan["slices"] * cb
            assert plan["blocks"] == n * plan["bands"] * plan["slices"]
            assert c % vec == 0 and vec & (vec - 1) == 0
            assert vec == 16 // esize or c % (2 * vec)
            assert cb & (cb - 1) == 0 and cb % vec == 0
            assert cb * esize >= 32 and cb <= 256
            min_cb = max(vec, 32 // esize)
            wide = max(min_cb, min(128 // esize,
                                   1 << (c - 1).bit_length()))
            if DC._fwd_smem_bytes(h, w, 1, wide, esize) <= 115_712:
                assert 2 * (plan["smem_bytes"] + 1024) <= 233_472
            if plan["blocks"] > 132 and \
                    DC._fwd_smem_bytes(h, w, 1, wide, esize) <= 232_448:
                assert cb >= wide
            vpp = cb // vec
            threads = plan["threads"]
            assert threads % 32 == 0 and threads % vpp == 0
            assert threads // vpp <= 128
            alone = 2 * (plan["smem_bytes"] + 1024) > 233_472
            assert threads == min(512 if alone else 256, 128 * vpp)
            assert plan["blocks"] >= 66 or (rows == 1 and cb == min_cb)
            if (n, dtype) in plans:
                assert (rows, cb, vec, threads, plan["blocks"]) == \
                    plans[(n, dtype)], (n, dtype, plan)
    if plans:
        assert len(plans) == 4
