"""The deformable-convolution ladder: DCNv2 of the resdcn and dla networks
and the CoDeNet paper's design space of offset constraints.

The JAX package's models/deform_modules.py (reference lib/models/
external/modules/dcn_deform_conv.py:61-384 and DCNv2/dcn_v2.py `DCN`),
on the general op `ops.deform_conv.deform_conv2d` in plain PyTorch (in
the JAX package it is XLA code, not a Pallas kernel; every rung is a
full, not a depthwise, conv, so the co-designed kernels do not apply).
The rungs, from free to constrained offsets:

- `DeformConvPack`, `DeformConvPack1x1`, `DeformConvPackDW`: free
  offsets from a kxk, a 1x1, or a depthwise + pointwise predictor;
- `ModulatedDeformConvPack`: DCNv2, offsets and a sigmoid mask;
- `DeformConvWithOffsetBound`: free offsets clipped to +-bound;
- `DeformConvWithOffsetRound`: integer offsets, the round passing the
  gradient straight through;
- `DeformConvWithOffsetScale`, `DeformConvWithOffsetScaleBound`: one
  scalar scale s per position, tap t at `anchor_t * (s - 1)` (a square
  pattern), s free or clipped to +-bound;
- `ModulatedDeformConvWithOffsetScaleBoundPositive`: the square pattern
  with s clipped to [0, bound] and a per-tap modulation (no sigmoid).

Module names follow the reference ``state_dict``: ``weight`` (OIHW),
``bias`` and the predictors ``conv_offset``, ``conv_offset_mask``,
``conv_dw``, ``conv_pw``, ``conv_scale`` and ``conv_mask``.
`reset_parameters(generator)` draws the JAX init. NCHW (channels_last)
in and out; the op runs on the NHWC views.
"""

from __future__ import annotations

import torch
from torch import nn

from ..ops.deform_conv import ANCHOR_OFFSETS, deform_conv2d
from .layers import deform_weight_init_, nchw, nhwc, torch_conv_init_


def _zero_conv(cin, cout, k, stride=1, padding=None, bias_value=0.0):
    conv = nn.Conv2d(cin, cout, k, stride,
                     k // 2 if padding is None else padding)
    conv.reset_value = bias_value
    return conv


def _zero_(conv):
    conv.weight.zero_()
    conv.bias.fill_(conv.reset_value)


def _square_offset(s):
    """Tap offsets `anchor_t * (s - 1)`, (N, H, W, 18), of the scale map s
    (N, H, W, 1)."""
    anchor = torch.as_tensor(ANCHOR_OFFSETS.reshape(18), device=s.device)
    return anchor * (s - 1.0)


class _DeformConv(nn.Module):
    """The deform conv's weight and the op; a rung predicts its offsets
    (and mask) in `offset_mask`."""

    def __init__(self, in_channels, out_channels, kernel_size=3, stride=1,
                 padding=1, groups=1, deformable_groups=1):
        super().__init__()
        self.in_channels = in_channels
        self.kernel_size = kernel_size
        self.stride = stride
        self.padding = padding
        self.groups = groups
        self.deformable_groups = deformable_groups
        self.weight = nn.Parameter(torch.empty(
            out_channels, in_channels // groups, kernel_size, kernel_size))

    @torch.no_grad()
    def reset_parameters(self, generator):
        """The JAX init: the weight U(+-1/sqrt(Cin * k * k)), the offset
        and scale predictors zero (scale bias 1: s = 1, no offset)."""
        deform_weight_init_(self.weight, self.in_channels, generator)
        for m in self.children():
            if hasattr(m, "reset_value"):
                _zero_(m)

    def offset_mask(self, x):
        raise NotImplementedError

    def deform(self, x):
        """The deform conv of x (NCHW), NHWC out."""
        offset, mask = self.offset_mask(x)
        return deform_conv2d(
            nhwc(x), offset, self.weight.permute(2, 3, 1, 0), self.stride,
            self.padding, 1, self.groups, self.deformable_groups, mask)

    def forward(self, x):
        return nchw(self.deform(x))


class DeformConvPack(_DeformConv):
    """Free offsets from a kxk predictor (reference :61-83)."""

    def __init__(self, in_channels, out_channels, kernel_size=3, stride=1,
                 padding=1, groups=1, deformable_groups=1):
        super().__init__(in_channels, out_channels, kernel_size, stride,
                         padding, groups, deformable_groups)
        self.conv_offset = _zero_conv(
            in_channels, deformable_groups * 2 * kernel_size ** 2,
            kernel_size, stride, padding)

    def offset_mask(self, x):
        return nhwc(self.conv_offset(x)), None


class DeformConvPack1x1(_DeformConv):
    """Free offsets from a 1x1 predictor (reference :86-108)."""

    def __init__(self, in_channels, out_channels, kernel_size=3, stride=1,
                 padding=1, groups=1, deformable_groups=1):
        super().__init__(in_channels, out_channels, kernel_size, stride,
                         padding, groups, deformable_groups)
        self.conv_offset = _zero_conv(
            in_channels, deformable_groups * 2 * kernel_size ** 2, 1,
            stride, 0)

    def offset_mask(self, x):
        return nhwc(self.conv_offset(x)), None


class DeformConvPackDW(_DeformConv):
    """Free offsets from a 3x3 depthwise conv (torch's default init) and a
    zero 1x1 (reference :111-129)."""

    def __init__(self, in_channels, out_channels, kernel_size=3, stride=1,
                 padding=1, groups=1, deformable_groups=1):
        super().__init__(in_channels, out_channels, kernel_size, stride,
                         padding, groups, deformable_groups)
        self.conv_dw = nn.Conv2d(in_channels, in_channels, 3, 1, 1,
                                 groups=in_channels)
        self.conv_pw = _zero_conv(in_channels, deformable_groups * 18, 1,
                                  1, 0)

    @torch.no_grad()
    def reset_parameters(self, generator):
        super().reset_parameters(generator)
        torch_conv_init_(self.conv_dw.weight, generator)
        self.conv_dw.bias.zero_()

    def offset_mask(self, x):
        return nhwc(self.conv_pw(self.conv_dw(x))), None


class ModulatedDeformConvPack(_DeformConv):
    """DCNv2 (reference :179-205 and DCNv2/dcn_v2.py:96-130 `DCN`): a kxk
    conv predicts dg * 3 * k * k channels, split into offsets o1, o2 and
    a mask (sigmoid); the deform conv samples with the offsets, scales
    each tap's columns by the mask and adds the bias.

    The offset of tap t is (o1[t], o2[t]), interleaved as the JAX package
    builds it (`stack([o1, o2], -1)`), not DCNv2's `cat((o1, o2), 1)`,
    under which tap t reads channels 2t and 2t + 1 of the concatenation:
    the two permute conv_offset_mask's first 2 * dg * k * k output
    channels (ROADMAP.md section 3)."""

    def __init__(self, in_channels, out_channels, kernel_size=3, stride=1,
                 padding=1, groups=1, deformable_groups=1, bias=True):
        super().__init__(in_channels, out_channels, kernel_size, stride,
                         padding, groups, deformable_groups)
        self.bias = nn.Parameter(torch.empty(out_channels)) if bias \
            else None
        self.conv_offset_mask = _zero_conv(
            in_channels, deformable_groups * 3 * kernel_size ** 2,
            kernel_size, stride, padding)

    @torch.no_grad()
    def reset_parameters(self, generator):
        """As the other rungs, and the bias zero (mask 0.5 at init)."""
        super().reset_parameters(generator)
        if self.bias is not None:
            self.bias.zero_()

    def offset_mask(self, x):
        om = nhwc(self.conv_offset_mask(x))
        o1, o2, mask = om.chunk(3, dim=-1)
        n, ho, wo, _ = o1.shape
        dg, kk = self.deformable_groups, self.kernel_size ** 2
        offset = torch.stack([o1.reshape(n, ho, wo, dg, kk),
                              o2.reshape(n, ho, wo, dg, kk)],
                             dim=-1).reshape(n, ho, wo, dg * 2 * kk)
        return offset, mask.sigmoid()

    def forward(self, x):
        y = self.deform(x)
        if self.bias is not None:
            y = y + self.bias
        return nchw(y)


class _Offset3x3(_DeformConv):
    """A 3x3, stride-1, full conv whose offsets (or scale) come from a
    zero 3x3 predictor `conv_offset` (or `conv_scale`, bias 1)."""

    def __init__(self, in_channels, out_channels, deformable_groups=1,
                 predictor="conv_offset"):
        super().__init__(in_channels, out_channels, 3, 1, 1, 1,
                         deformable_groups)
        dg = deformable_groups
        if predictor == "conv_offset":
            self.conv_offset = _zero_conv(in_channels, dg * 18, 3)
        else:
            self.conv_scale = _zero_conv(in_channels, dg, 3,
                                         bias_value=1.0)


class DeformConvWithOffsetBound(_Offset3x3):
    """Free offsets clipped to [-bound, bound] (reference :208-222)."""

    def __init__(self, in_channels, out_channels, offset_bound=8,
                 deformable_groups=1):
        super().__init__(in_channels, out_channels, deformable_groups)
        self.offset_bound = offset_bound

    def offset_mask(self, x):
        b = self.offset_bound
        return nhwc(self.conv_offset(x)).clamp(-b, b), None


class DeformConvWithOffsetRound(_Offset3x3):
    """Integer offsets, no bilinear blend (reference :225-237); the round
    passes the gradient straight through, so the predictor trains."""

    def offset_mask(self, x):
        o = nhwc(self.conv_offset(x))
        return o + (torch.round(o) - o).detach(), None


class DeformConvWithOffsetScale(_Offset3x3):
    """One free scalar scale per position: a square pattern (reference
    :240-258)."""

    def __init__(self, in_channels, out_channels, deformable_groups=1):
        super().__init__(in_channels, out_channels, deformable_groups,
                         "conv_scale")

    def offset_mask(self, x):
        return _square_offset(nhwc(self.conv_scale(x))), None


class DeformConvWithOffsetScaleBound(_Offset3x3):
    """The scale clipped to [-bound, bound] (reference :261-282)."""

    def __init__(self, in_channels, out_channels, offset_bound=8,
                 deformable_groups=1):
        super().__init__(in_channels, out_channels, deformable_groups,
                         "conv_scale")
        self.offset_bound = offset_bound

    def offset_mask(self, x):
        b = self.offset_bound
        return _square_offset(nhwc(self.conv_scale(x)).clamp(-b, b)), None


class ModulatedDeformConvWithOffsetScaleBoundPositive(_Offset3x3):
    """The square pattern with the scale clipped to [0, bound], and a
    per-tap modulation from `conv_mask` (torch's default init, bias 0; no
    sigmoid) (reference :333-357)."""

    def __init__(self, in_channels, out_channels, offset_bound=8,
                 deformable_groups=1):
        super().__init__(in_channels, out_channels, deformable_groups,
                         "conv_scale")
        self.offset_bound = offset_bound
        self.conv_mask = nn.Conv2d(in_channels, deformable_groups * 9, 3, 1,
                                   1)

    @torch.no_grad()
    def reset_parameters(self, generator):
        super().reset_parameters(generator)
        torch_conv_init_(self.conv_mask.weight, generator)
        self.conv_mask.bias.zero_()

    def offset_mask(self, x):
        s = nhwc(self.conv_scale(x)).clamp(0, self.offset_bound)
        return _square_offset(s), nhwc(self.conv_mask(x))


LADDER = (DeformConvPack, DeformConvPack1x1, DeformConvPackDW,
          ModulatedDeformConvPack, DeformConvWithOffsetBound,
          DeformConvWithOffsetRound, DeformConvWithOffsetScale,
          DeformConvWithOffsetScaleBound,
          ModulatedDeformConvWithOffsetScaleBoundPositive)
