"""DCNv2, the modulated deformable conv of the resdcn and dla networks.

The JAX package's models/deform_modules.py:103-141 (reference DCNv2/
dcn_v2.py `DCN`, the module of resnet_dcn.py's deconv stages and
pose_dla_dcn.py's IDA nodes), on the general op `ops.deform_conv.
deform_conv2d` in plain PyTorch. Module names follow the reference
``state_dict``: ``weight`` (OIHW), ``bias`` and the offset-and-mask
predictor ``conv_offset_mask``. The JAX package's other ladder rungs of
that file are not ported (ROADMAP.md item 21).
"""

from __future__ import annotations

import torch
from torch import nn

from ..ops.deform_conv import deform_conv2d
from .layers import deform_weight_init_, nchw, nhwc


class ModulatedDeformConvPack(nn.Module):
    """DCNv2: a kxk conv predicts dg * 3 * k * k channels, split into
    offsets o1, o2 and a mask (sigmoid); the deform conv samples with the
    offsets, scales each tap's columns by the mask and adds the bias.

    The offset of tap t is (o1[t], o2[t]), interleaved as the JAX package
    builds it (`stack([o1, o2], -1)`), not DCNv2's `cat((o1, o2), 1)`,
    under which tap t reads channels 2t and 2t + 1 of the concatenation:
    the two permute conv_offset_mask's first 2 * dg * k * k output
    channels (ROADMAP.md section 3).

    NCHW (channels_last) in and out; the op runs on the NHWC views.
    """

    def __init__(self, in_channels, out_channels, kernel_size=3, stride=1,
                 padding=1, groups=1, deformable_groups=1, bias=True):
        super().__init__()
        self.in_channels = in_channels
        self.kernel_size = kernel_size
        self.stride = stride
        self.padding = padding
        self.groups = groups
        self.deformable_groups = deformable_groups
        self.weight = nn.Parameter(torch.empty(
            out_channels, in_channels // groups, kernel_size, kernel_size))
        self.bias = nn.Parameter(torch.empty(out_channels)) if bias \
            else None
        self.conv_offset_mask = nn.Conv2d(
            in_channels, deformable_groups * 3 * kernel_size * kernel_size,
            kernel_size, stride, padding, bias=True)

    @torch.no_grad()
    def reset_parameters(self, generator):
        """The JAX init: the weight U(+-1/sqrt(Cin * k * k)), the bias and
        conv_offset_mask zero (offsets 0, mask 0.5)."""
        deform_weight_init_(self.weight, self.in_channels, generator)
        if self.bias is not None:
            self.bias.zero_()
        self.conv_offset_mask.weight.zero_()
        self.conv_offset_mask.bias.zero_()

    def forward(self, x):
        om = nhwc(self.conv_offset_mask(x))
        o1, o2, mask = om.chunk(3, dim=-1)
        n, ho, wo, _ = o1.shape
        dg, kk = self.deformable_groups, self.kernel_size ** 2
        offset = torch.stack([o1.reshape(n, ho, wo, dg, kk),
                              o2.reshape(n, ho, wo, dg, kk)],
                             dim=-1).reshape(n, ho, wo, dg * 2 * kk)
        y = deform_conv2d(nhwc(x), offset, self.weight.permute(2, 3, 1, 0),
                          self.stride, self.padding, 1, self.groups, dg,
                          mask.sigmoid())
        if self.bias is not None:
            y = y + self.bias
        return nchw(y)
