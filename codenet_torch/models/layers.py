"""Shared layers: layout helpers, shuffle-unit pieces, init functions and
the co-designed deformable block.

Inside the network activations are NCHW-logical tensors in
``torch.channels_last`` memory format, so ``nhwc(x)`` is a free view of
the (N, H, W, C) C-contiguous buffer the deform kernel reads. The public
helpers here keep the JAX package's NHWC layout.

Conv + BN pairs are plain ``nn.Conv2d`` (no bias) + ``nn.BatchNorm2d``
(momentum 0.1, eps 1e-5: torch semantics, as the JAX ``ConvBN`` mirrors)
placed at the reference ``nn.Sequential`` indices by the model, so the
``state_dict`` has the reference CoDeNet names. Quantized execution
(``QuantSpec``, ``QuantAct``) is not ported yet.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

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


class DeformWeight(nn.Module):
    """Holder of the depthwise deform kernel, OIHW (C, 1, 3, 3), named like
    the reference's DeformConv submodule (``...conv.weight``)."""

    def __init__(self, channels):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(channels, 1, 3, 3))


class CodesignDeformBlock(nn.Module):
    """DeformConvWithOffsetScaleBoundPositive (reference
    modules/dcn_deform_conv.py:285-330), FP32:

      s = Hardtanh[-bound+1, bound](conv_scale(x))
      y = depthwise co-designed deform conv of x with s
      y = conv_channel(y) if in != out

    The BatchNorm, ReLU and upsample that follow in the deconv stage are
    the caller's modules (reference ``deconv_layers.{4i+1..4i+3}``), so the
    JAX package's ``CodesignDeformBlock`` equals this block followed by
    that BatchNorm. Stride 1 runs ``codesign_deform_conv_fast`` (the CUDA
    kernel on a card); stride 2 the plain ``codesign_deform_conv``, as in
    the JAX package (layers.py:559-576).
    """

    def __init__(self, in_channels, features, stride=1, offset_bound=8,
                 qspec=None):
        super().__init__()
        if qspec is not None:
            raise NotImplementedError(
                "quantized CodesignDeformBlock is queued in ROADMAP.md")
        self.stride = stride
        self.offset_bound = offset_bound
        self.conv_scale = conv(in_channels, 1, 1, stride, 0, bias=True)
        self.conv = DeformWeight(in_channels)
        self.conv_channel = (conv(in_channels, features)
                             if in_channels != features else None)

    @torch.no_grad()
    def reset_parameters(self, generator):
        # scale predictor: weight zero, bias one (dcn_deform_conv.py:295-302)
        self.conv_scale.weight.zero_()
        self.conv_scale.bias.fill_(1.0)
        deform_weight_init_(self.conv.weight, self.conv.weight.shape[0],
                            generator)
        if self.conv_channel is not None:
            kaiming_normal_relu_(self.conv_channel.weight, generator)

    def forward(self, x):
        s = F.hardtanh(self.conv_scale(x), -self.offset_bound + 1,
                       self.offset_bound)
        x_nhwc = nhwc(x.contiguous(memory_format=torch.channels_last))
        s_nhwc = nhwc(s).contiguous()
        w_hwio = self.conv.weight.permute(2, 3, 1, 0)
        if self.stride == 1:
            y = codesign_deform_conv_fast(x_nhwc, s_nhwc, w_hwio)
        else:
            y = codesign_deform_conv(x_nhwc, s_nhwc, w_hwio,
                                     stride=self.stride)
        y = nchw(y)
        if self.conv_channel is not None:
            y = self.conv_channel(y)
        return y
