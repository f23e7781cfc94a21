"""W4A8 fake-quantization math, functional (the JAX package's
ops/quant.py, fake-quant part).

Reproduces the reference portable_quantizer numerics
(quantization_utils/quant_utils.py):

- symmetric weight quantization, per output channel, optional 0.1/99.9
  percentile range, clamped to [-2^(k-1), 2^(k-1) - 1];
- asymmetric activation quantization with an integral zero point and the
  signed +2^(k-1) shift; the activation path does NOT clamp unless asked
  (a quirk kept on purpose);
- EMA min/max activation ranges, momentum 0.99, with the first-batch case
  (`x_min == x_max` adds the batch range);
- the straight-through estimator: forward q(x), backward identity, as
  `x + (q(x) - x)` with the difference taken out of the graph (the JAX
  package's `x + stop_gradient(q(x) - x)`, same rounding).

Weights arrive in PyTorch's OIHW layout; per-channel ranges are taken over
each output channel's flattened (I, kh, kw) elements, whose order does not
change a min, a max or a k-th value. `torch.round` rounds half to even,
as `jnp.round` does.

Real-int8 inference (the JAX package's ops/quant.py, int8 part):
`QTensor` activations (int8 values, scalar scale and zero point),
`quantize_act_int8`, `quantize_weight_int` and `int8_conv`, NCHW/OIHW.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

from ..parallel.mesh import all_gather_rows, all_max


def _ste(x, qx_fn):
    """Forward qx_fn(x), backward identity."""
    with torch.no_grad():
        delta = qx_fn(x) - x
    return x + delta


def percentile_min_max(flat, lower=0.1, upper=99.9):
    """torch-kthvalue percentile bounds, round-indexed (quant_utils.py:
    16-28)."""
    n = flat.shape[0]
    lo_idx = int(round(n * lower * 0.01))
    up_idx = int(round(n * upper * 0.01))
    s = torch.sort(flat).values
    return s[max(lo_idx, 1) - 1], s[max(up_idx, 1) - 1]


def weight_channel_min_max(w_oc_first, percentile=False):
    """Per-output-channel (min, max) of an (O, L) weight view
    (Quant_Conv2d.forward, quant_modules.py:280-301): percentile mode uses
    ceil-indexed kthvalue; fewer than 10 elements per channel fall back to
    0.95 * min/max."""
    _, length = w_oc_first.shape
    if not percentile:
        return w_oc_first.amin(dim=1), w_oc_first.amax(dim=1)
    if length < 10:
        return (w_oc_first.amin(dim=1) * 0.95,
                w_oc_first.amax(dim=1) * 0.95)
    lo_idx = max(int(math.ceil(length * 0.1 * 0.01)), 1)
    up_idx = min(max(int(math.ceil(length * 99.9 * 0.01)), 1), length)
    s = torch.sort(w_oc_first, dim=1).values
    return s[:, lo_idx - 1], s[:, up_idx - 1]


def _over(n, t):
    """n / t correctly rounded (a Python number over a tensor computes
    t.reciprocal() * n, which rounds twice)."""
    return t.new_tensor(float(n)) / t


def _symmetric(x, k, x_min, x_max):
    magnitude = torch.maximum(x_min.abs(), x_max.abs())
    n = 2 ** (k - 1) - 1
    scale = _over(n, torch.clamp(magnitude, min=1e-10))
    q = torch.round(scale * x)
    q = torch.clamp(q, -(2 ** (k - 1)), 2 ** (k - 1) - 1)
    return q / scale


def _asymmetric(x, k, x_min, x_max, clamp):
    n = 2 ** k - 1
    scale = _over(n, torch.clamp(x_max - x_min, min=1e-10))
    zero_point = torch.round(scale * x_min)
    zero_point = zero_point + 2 ** (k - 1)  # signed shift
    q = torch.round(scale * x - zero_point)
    if clamp:
        q = torch.clamp(q, -(2 ** (k - 1)), 2 ** (k - 1) - 1)
    return (q + zero_point) / scale


def symmetric_quant(x, k, x_min, x_max):
    """SymmetricQuantFunction (quant_utils.py:205-223), STE backward;
    x_min/x_max must broadcast against x."""
    return _ste(x, lambda v: _symmetric(v, k, x_min, x_max))


def asymmetric_quant(x, k, x_min, x_max, clamp=False):
    """AsymmetricQuantFunction (quant_utils.py:170-198), STE backward.
    clamp=True clamps to the signed int8 storage window
    [-2^(k-1), 2^(k-1) - 1]."""
    return _ste(x, lambda v: _asymmetric(v, k, x_min, x_max, clamp))


def fake_quant_weight(w_oihw, k, percentile=False):
    """Fake-quantize an OIHW weight, symmetric, per output channel."""
    o = w_oihw.shape[0]
    with torch.no_grad():
        w_min, w_max = weight_channel_min_max(w_oihw.reshape(o, -1),
                                              percentile)
    return symmetric_quant(w_oihw, k, w_min[:, None, None, None],
                           w_max[:, None, None, None])


def fake_quant_act(x, k, x_min, x_max, clamp=False):
    """Fake-quantize activations, asymmetric, with scalar range state.
    clamp=False is the reference quirk (no clamp to the representable
    window); clamp=True clamps to the signed int8 window, as real int8
    storage does."""
    return asymmetric_quant(x, k, x_min, x_max, clamp=clamp)


@torch.no_grad()
def act_range_observe(x, percentile=False, dp=None):
    """Batch (min, max) for the EMA (quant_modules.py:204-209). Under data
    parallelism (`dp`) the range of the global batch: the min and max
    all-reduced (one MAX over (-min, max)), and the percentiles taken
    over every rank's values gathered in rank order, the concatenated
    batch (a percentile of the union is no function of local ones)."""
    flat = x.detach().reshape(-1)
    if percentile:
        return percentile_min_max(all_gather_rows(flat, dp).reshape(-1),
                                  0.1, 99.9)
    if dp is None:
        return flat.min(), flat.max()
    lo_hi = all_max(torch.stack([-flat.min(), flat.max()]), dp)
    return -lo_hi[0], lo_hi[1]


@torch.no_grad()
def ema_update(x_min, x_max, batch_min, batch_max, momentum=0.99):
    """EMA with the first-batch case (quant_modules.py:210-219); state
    tensors are shape (1,)."""
    init = x_min == x_max
    new_min = torch.where(init, x_min + batch_min,
                          momentum * x_min + (1.0 - momentum) * batch_min)
    new_max = torch.where(init, x_max + batch_max,
                          momentum * x_max + (1.0 - momentum) * batch_max)
    return new_min, new_max


def fold_bn(w_oihw, conv_bias, bn_gamma, bn_beta, bn_mean, bn_var,
            eps=1e-5):
    """Fold BN into the conv from (frozen) running statistics
    (QuantBnConv2d.forward, quant_modules.py:364-372). Returns the scaled
    OIHW weight and bias."""
    std = torch.sqrt(bn_var + eps)
    factor = bn_gamma / std
    scaled_w = w_oihw * factor[:, None, None, None]
    bias = conv_bias if conv_bias is not None else torch.zeros_like(bn_mean)
    scaled_b = (bias - bn_mean) * factor + bn_beta
    return scaled_w, scaled_b


# -- real-int8 inference -------------------------------------------------------

class QTensor(NamedTuple):
    """A quantized activation: int8 values (NCHW, channels_last) with (1,)
    f32 scale and zero point (an integral value that already holds the
    signed +2^(k-1) shift): x = (values + zero_point) / scale
    (quant_utils.py:42-50)."""
    values: torch.Tensor
    scale: torch.Tensor
    zero_point: torch.Tensor

    def dequant(self):
        return (self.values.float() + self.zero_point) / self.scale


@torch.no_grad()
def quantize_act_int8(x, k, x_min, x_max):
    """int8 storage of f32 activations from frozen EMA ranges: the scale
    and zero point of `fake_quant_act`, values clamped to the signed window
    [-2^(k-1), 2^(k-1) - 1] (the clamp=True fake-quant, exactly)."""
    n = 2 ** k - 1
    scale = _over(n, torch.clamp(x_max - x_min, min=1e-10))
    zero_point = torch.round(scale * x_min) + 2 ** (k - 1)
    q = torch.round(scale * x - zero_point)
    q = torch.clamp(q, -(2 ** (k - 1)), 2 ** (k - 1) - 1)
    return QTensor(q.to(torch.int8), scale.float(), zero_point.float())


@torch.no_grad()
def quantize_weight_int(w_oihw, k, percentile=False):
    """Integer weight levels (int8 tensor, OIHW) and the per-output-channel
    f32 scale, w ~= q / scale: the ranges and rounding of
    `fake_quant_weight`."""
    o = w_oihw.shape[0]
    w_min, w_max = weight_channel_min_max(w_oihw.reshape(o, -1), percentile)
    magnitude = torch.maximum(w_min.abs(), w_max.abs())
    scale = _over(2 ** (k - 1) - 1, torch.clamp(magnitude, min=1e-10))
    q = torch.round(w_oihw * scale[:, None, None, None])
    q = torch.clamp(q, -(2 ** (k - 1)), 2 ** (k - 1) - 1)
    return q.to(torch.int8), scale.float()


def _pair(v):
    return tuple(v) if isinstance(v, (tuple, list)) else (v, v)


def int8_conv_terms(values, q_w, stride=1, padding=1, groups=1):
    """The integer parts of `int8_conv`, as exact f32: the accumulator
    conv(values, q_w) and the zero-point factor, the sum of q_w over the
    taps that fall inside the map.

    Every operand is an int8 level (|v| <= 128) or a weight level (|q| <=
    2^(w_bit - 1): 8 at 4 bits, 128 for layer0's 8 bits), exact in f32 and
    in TF32 (11 significant bits). Every partial sum is bounded by the
    conv's fan-in per output (Cin / groups x kh x kw) x 128 x the weight
    level bound, below 2^24 in every config (a-e), so a float conv of the
    integer values sums exactly in any order. The largest is in configs d
    and e (--w2): deconv0's 1x1 mixer over 2153 channels, 2153 x 128 x 8
    = 2,204,672 (layer4's 1x1 over 976: 999,424; layer0: 27 x 128 x 128
    = 442,368); at 1x, deconv0's mixer over 1024 channels, 1,048,576.
    tests/test_torch_w2_int8.py::test_int8_partial_sums_exact_in_f32
    computes the bound of every int8 conv of configs d and e and holds
    their accumulators to the exact f64 sums. Unpadded 1x1 convs are a
    matmul of the (positions, Cin) values, their factor a per-channel
    constant (O,); the rest are a conv, their factor a conv of a ones map
    with the channel-summed kernel, (1, O, Ho, Wo)."""
    stride, padding = _pair(stride), _pair(padding)
    o, _, kh, kw = q_w.shape
    wf = q_w.float()
    if (kh, kw) == (1, 1) and groups == 1 and padding == (0, 0):
        v = values[:, :, ::stride[0], ::stride[1]]
        n, cin, ho, wo = v.shape
        rows = v.permute(0, 2, 3, 1).reshape(-1, cin).float()
        acc = (rows @ wf.reshape(o, cin).t()).reshape(n, ho, wo, o)
        return acc.permute(0, 3, 1, 2), wf.sum((1, 2, 3))
    acc = F.conv2d(values.float(), wf, None, stride, padding, 1, groups)
    ones = wf.new_ones((1, 1) + tuple(values.shape[2:]))
    valid_wsum = F.conv2d(ones, wf.sum(1, keepdim=True), None, stride,
                          padding)
    return acc, valid_wsum


def int8_conv(qx, q_w, w_scale, bias, stride=1, padding=1, groups=1):
    """Integer convolution with fused requantization (the JAX package's
    quant.py:225-281): with x = (v + zp) / s and w = q / s_w,

      conv(x, w) = (conv(v, q) + zp * taps_sum(q)) / (s * s_w) + bias,

    in the JAX order of f32 operations, so the same accumulator gives the
    same bits. qx a QTensor, q_w int8 OIHW, w_scale (O,), bias (O,) or
    None; returns f32 NCHW."""
    acc, wsum = int8_conv_terms(qx.values, q_w, stride, padding, groups)
    if wsum.dim() == 1:
        wsum = wsum[None, :, None, None]
    y = (acc + qx.zero_point * wsum) / (
        qx.scale * w_scale[None, :, None, None])
    if bias is not None:
        y = y + bias[None, :, None, None]
    return y
