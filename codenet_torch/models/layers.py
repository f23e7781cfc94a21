"""Shared layers: layout helpers, shuffle-unit pieces, init functions and
the co-designed deformable block.

Inside the network activations are NCHW-logical tensors in
``torch.channels_last`` memory format, so ``nhwc(x)`` is a free view of
the (N, H, W, C) C-contiguous buffer the deform kernel reads. The public
helpers here keep the JAX package's NHWC layout.

Conv + BN pairs are plain ``nn.Conv2d`` (no bias) + ``nn.BatchNorm2d``
(momentum 0.1, eps 1e-5: torch semantics, as the JAX ``ConvBN`` mirrors)
placed at the reference ``nn.Sequential`` indices by the model, so the
``state_dict`` has the reference CoDeNet names.

Quantized (W4A8 fake-quant) execution follows the JAX package's layers.py:
one module tree for both modes, selected by a ``QuantSpec`` (None = FP32).
``conv_bn`` folds each BN from its running statistics into the conv and
fake-quantizes the folded weight (BN frozen, whatever the module's
train/eval mode); ``QuantAct`` holds the activation-range EMA in buffers
(the JAX ``quant_stats`` collection) and updates it only when called with
``update=True``, a flag of its own. Real-int8 execution (``int8_infer``)
is not ported yet and raises.
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F
from torch import nn

from ..ops import quant as Q
from ..ops.deform_conv import codesign_deform_conv
from ..ops.deform_cuda import codesign_deform_conv_fast


def nhwc(x):
    """(N, C, H, W) channels_last -> (N, H, W, C) view."""
    return x.permute(0, 2, 3, 1)


def nchw(x):
    """(N, H, W, C) -> (N, C, H, W) view (channels_last if x is
    contiguous)."""
    return x.permute(0, 3, 1, 2)


def max_pool(x, window=3, stride=2, padding=1):
    """Max pooling, NHWC (torch nn.MaxPool2d semantics)."""
    return nhwc(F.max_pool2d(nchw(x), window, stride, padding))


def upsample_nearest_2x(x):
    """2x nearest-neighbour upsample, NHWC (nn.Upsample(scale_factor=2))."""
    return nhwc(F.interpolate(nchw(x), scale_factor=2, mode="nearest"))


def channel_shuffle(x, groups=2):
    """ShuffleNet channel shuffle, NHWC (reference shufflenetv2_dcn.py:
    29-34). Returns a C-contiguous tensor."""
    n, h, w, c = x.shape
    x = x.reshape(n, h, w, groups, c // groups).transpose(3, 4)
    return x.reshape(n, h, w, c)


# -- init functions (the JAX package's layers.py:145-173) ------------------

def _fan_in(weight):
    """OIHW weight: kh * kw * Cin/groups."""
    return weight[0].numel()


@torch.no_grad()
def torch_conv_init_(weight, generator):
    """torch nn.Conv2d default (kaiming_uniform a=sqrt(5)):
    U(+-1/sqrt(fan_in))."""
    bound = 1.0 / math.sqrt(_fan_in(weight))
    return weight.uniform_(-bound, bound, generator=generator)


@torch.no_grad()
def kaiming_normal_relu_(weight, generator):
    """kaiming_normal_(nonlinearity='relu'): normal(0, sqrt(2/fan_in))."""
    std = math.sqrt(2.0 / _fan_in(weight))
    return weight.normal_(0.0, std, generator=generator)


@torch.no_grad()
def deform_weight_init_(weight, in_channels, generator):
    """DeformConv.reset_parameters (modules/dcn_deform_conv.py:49-54):
    U(+-1/sqrt(in_channels * kh * kw)) — full in_channels, not per group."""
    kh, kw = weight.shape[2], weight.shape[3]
    bound = 1.0 / math.sqrt(in_channels * kh * kw)
    return weight.uniform_(-bound, bound, generator=generator)


def conv(cin, cout, kernel_size=1, stride=1, padding=0, groups=1,
         bias=False):
    return nn.Conv2d(cin, cout, kernel_size, stride, padding, groups=groups,
                     bias=bias)


def bn(c):
    return nn.BatchNorm2d(c, eps=1e-5, momentum=0.1)


# -- quantized execution (the JAX package's layers.py:121-143, 267-508) ----

@dataclasses.dataclass(frozen=True)
class QuantSpec:
    """Static quantization configuration (reference quantize_model.py:
    7-24). act_clamp: clamp fake-quantized activations to the signed int8
    window, as real int8 storage does (the reference does not)."""
    w_bit: int = 4
    a_bit: int = 8
    wt_percentile: bool = False
    act_percentile: bool = False
    int8_infer: bool = False
    act_clamp: bool = False


def qspec_from_opt(opt):
    """The W4A8 recipe of the command-line flags (the JAX package's
    cli/quant_main.py and detector: symmetric per-channel weights,
    asymmetric activations)."""
    return QuantSpec(w_bit=opt.w_bit, a_bit=opt.a_bit,
                     wt_percentile=opt.wt_percentile,
                     act_percentile=opt.act_percentile,
                     int8_infer=opt.int8_infer, act_clamp=opt.act_clamp)


def check_qspec(qspec):
    if qspec is not None and qspec.int8_infer:
        raise NotImplementedError(
            "real-int8 execution (--int8_infer) is queued in ROADMAP.md; "
            "the port runs W4A8 fake-quant")


class QuantAct(nn.Module):
    """EMA-range activation fake-quantizer (reference QuantAct,
    quant_modules.py:163-225). `x_min`/`x_max` are buffers; with
    update=True the EMA takes this batch's range before quantizing."""

    def __init__(self, qspec):
        super().__init__()
        check_qspec(qspec)
        self.qspec = qspec
        self.register_buffer("x_min", torch.zeros(1))
        self.register_buffer("x_max", torch.zeros(1))

    def forward(self, x, update=False):
        q = self.qspec
        if update:
            with torch.no_grad():
                bmin, bmax = Q.act_range_observe(x, q.act_percentile)
                nmin, nmax = Q.ema_update(self.x_min, self.x_max, bmin,
                                          bmax)
                self.x_min.copy_(nmin)
                self.x_max.copy_(nmax)
        out = Q.fake_quant_act(x.float(), q.a_bit, self.x_min, self.x_max,
                               clamp=q.act_clamp)
        return out.to(x.dtype)


def quant_act(qspec):
    """A QuantAct, or None in FP32 (no buffers, FP32 state_dict as is)."""
    return QuantAct(qspec) if qspec is not None else None


def apply_act(act, x, update):
    return x if act is None else act(x, update)


def fake_quant(weight, qspec, w_bit=None):
    return Q.fake_quant_weight(weight, w_bit or qspec.w_bit,
                               qspec.wt_percentile)


def conv_q(conv_mod, x, qspec, w_bit=None):
    """Conv with the weight fake-quantized in quant mode; the bias stays
    full precision (reference Quant_Conv2d, quant_modules.py:228-321)."""
    if qspec is None:
        return conv_mod(x)
    return F.conv2d(x, fake_quant(conv_mod.weight, qspec, w_bit),
                    conv_mod.bias, conv_mod.stride, conv_mod.padding,
                    conv_mod.dilation, conv_mod.groups)


def conv_bn(conv_mod, bn_mod, x, qspec, w_bit=None):
    """Conv + BN. FP32: the two modules (BN in its train/eval mode).
    Quant: BN folded from its running statistics, the folded weight
    fake-quantized, one conv (reference QuantBnConv2d,
    quant_modules.py:324-419): QAT trains against frozen folded BN."""
    if qspec is None:
        return bn_mod(conv_mod(x))
    w, b = Q.fold_bn(conv_mod.weight, None, bn_mod.weight, bn_mod.bias,
                     bn_mod.running_mean, bn_mod.running_var, bn_mod.eps)
    return F.conv2d(x, fake_quant(w, qspec, w_bit), b, conv_mod.stride,
                    conv_mod.padding, conv_mod.dilation, conv_mod.groups)


class DeformWeight(nn.Module):
    """Holder of the depthwise deform kernel, OIHW (C, 1, 3, 3), named like
    the reference's DeformConv submodule (``...conv.weight``)."""

    def __init__(self, channels):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(channels, 1, 3, 3))


class CodesignDeformBlock(nn.Module):
    """DeformConvWithOffsetScaleBoundPositive (reference
    modules/dcn_deform_conv.py:285-330):

      s = Hardtanh[-bound+1, bound](conv_scale(x))
      y = depthwise co-designed deform conv of x with s
      y = BN(conv_channel(y)) if in != out else BN(y)

    The BatchNorm is the caller's module (reference
    ``deconv_layers.{4i+1}``), passed in as `bn`. The JAX package's
    ``CodesignDeformBlock`` is this block with that BN. Stride 1 runs
    ``codesign_deform_conv_fast`` (the CUDA kernels on a card, forward and
    backward); stride 2 the plain ``codesign_deform_conv``, as in the JAX
    package (layers.py:559-576).

    Quant (reference QuantDeformConvWithOffsetScaleBoundPositive,
    quant_modules.py:621-671): conv_scale's weight fake-quantized, s
    through `scale_act`, the deform weight fake-quantized, `deform_act`
    between the deform conv and the mixer, and the mixer + BN folded.
    """

    def __init__(self, in_channels, features, stride=1, offset_bound=8,
                 qspec=None):
        super().__init__()
        self.qspec = qspec
        self.stride = stride
        self.offset_bound = offset_bound
        self.conv_scale = conv(in_channels, 1, 1, stride, 0, bias=True)
        self.conv = DeformWeight(in_channels)
        self.conv_channel = (conv(in_channels, features)
                             if in_channels != features else None)
        self.scale_act = quant_act(qspec)
        self.deform_act = quant_act(qspec)

    @torch.no_grad()
    def reset_parameters(self, generator):
        # scale predictor: weight zero, bias one (dcn_deform_conv.py:295-302)
        self.conv_scale.weight.zero_()
        self.conv_scale.bias.fill_(1.0)
        deform_weight_init_(self.conv.weight, self.conv.weight.shape[0],
                            generator)
        if self.conv_channel is not None:
            kaiming_normal_relu_(self.conv_channel.weight, generator)

    def forward(self, x, bn, update=False):
        q = self.qspec
        s = F.hardtanh(conv_q(self.conv_scale, x, q),
                       -self.offset_bound + 1, self.offset_bound)
        s = apply_act(self.scale_act, s, update)
        x_nhwc = nhwc(x.contiguous(memory_format=torch.channels_last))
        s_nhwc = nhwc(s).contiguous()
        weight = self.conv.weight if q is None \
            else fake_quant(self.conv.weight, q)
        w_hwio = weight.permute(2, 3, 1, 0)
        if self.stride == 1:
            y = codesign_deform_conv_fast(x_nhwc, s_nhwc, w_hwio)
        else:
            y = codesign_deform_conv(x_nhwc, s_nhwc, w_hwio,
                                     stride=self.stride)
        y = apply_act(self.deform_act, nchw(y), update)
        if self.conv_channel is not None:
            return conv_bn(self.conv_channel, bn, y, q)
        if q is None:
            return bn(y)
        # quant mode without a mixer: BN from running stats, unfolded (the
        # JAX BatchNorm with train=False)
        return F.batch_norm(y, bn.running_mean, bn.running_var, bn.weight,
                            bn.bias, False, 0.0, bn.eps)
