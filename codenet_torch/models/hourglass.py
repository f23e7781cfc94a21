"""Large Hourglass (CornerNet's exkp), two stacks with intermediate
supervision.

PyTorch port of the JAX package's models/hourglass.py (reference
lib/models/networks/large_hourglass.py), FP32 (a QuantSpec prints a
warning, ``dtype`` is not read, as in the JAX package). The stem (7x7 s2
conv to 128, a stride-2 residual to 256) feeds each stack's recursive
hourglass (n = 5, dims 256, 256, 384, 384, 384, 512, modules 2, 2, 2, 2,
2, 4; stride-2 residuals in place of pooling); each stack has its own
heads (3x3 conv with bias + ReLU, 1x1 to classes; 256 channels whatever
head_conv says), and the stacks chain through the inters/cnvs_ merge.

Module names follow the reference ``state_dict`` (the layout the JAX
package's engine/torch_import.py::convert_hourglass reads): ``pre.{0,1}``,
``kps.{s}.{up1,low1,low2,low3}...``, ``cnvs.{s}``, ``inters_.{s}``,
``cnvs_.{s}``, ``inters.{s}`` and heads ``{head}.{s}.0.conv`` /
``{head}.{s}.1``.

`forward(images)` returns a LIST of head dicts, one per stack; the loss
averages over them and the detectors read the last.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .layers import bn, conv, nchw, nhwc, torch_conv_init_

DIMS = (256, 256, 384, 384, 384, 512)
MODULES = (2, 2, 2, 2, 2, 4)


class ConvBlock(nn.Module):
    """The reference `convolution` (:17-30): conv (+ BN) + ReLU; without
    BN the conv has a bias."""

    def __init__(self, k, inp, out, stride=1, with_bn=True):
        super().__init__()
        self.conv = conv(inp, out, k, stride, (k - 1) // 2,
                         bias=not with_bn)
        self.bn = bn(out) if with_bn else None

    def forward(self, x):
        y = self.conv(x)
        return F.relu(y if self.bn is None else self.bn(y))


class Residual(nn.Module):
    """The reference `residual` (:49-76)."""

    def __init__(self, inp, out, stride=1):
        super().__init__()
        self.conv1 = conv(inp, out, 3, stride, 1)
        self.bn1 = bn(out)
        self.conv2 = conv(out, out, 3, 1, 1)
        self.bn2 = bn(out)
        self.skip = nn.Sequential(conv(inp, out, 1, stride), bn(out)) \
            if stride != 1 or inp != out else None

    def forward(self, x):
        y = F.relu(self.bn1(self.conv1(x)))
        y = self.bn2(self.conv2(y))
        return F.relu(y + (x if self.skip is None else self.skip(x)))


def residual_chain(inp, out, modules, mode):
    """make_layer ('up': inp->out then out->out), make_layer_revr ('revr':
    inp->inp then inp->out) and make_hg_layer ('hg': a stride-2 inp->out
    then out->out) as one Sequential."""
    if mode == "revr":
        mods = [Residual(inp, inp) for _ in range(modules - 1)]
        return nn.Sequential(*mods, Residual(inp, out))
    first = Residual(inp, out, 2 if mode == "hg" else 1)
    return nn.Sequential(first,
                         *[Residual(out, out) for _ in range(modules - 1)])


class KpModule(nn.Module):
    """Recursive hourglass (reference kp_module :128-186)."""

    def __init__(self, n, dims, modules):
        super().__init__()
        curr_dim, next_dim = dims[0], dims[1]
        self.up1 = residual_chain(curr_dim, curr_dim, modules[0], "up")
        self.low1 = residual_chain(curr_dim, next_dim, modules[0], "hg")
        self.low2 = KpModule(n - 1, dims[1:], modules[1:]) if n > 1 \
            else residual_chain(next_dim, next_dim, modules[1], "up")
        self.low3 = residual_chain(next_dim, curr_dim, modules[0], "revr")

    def forward(self, x):
        low = self.low3(self.low2(self.low1(x)))
        return self.up1(x) + F.interpolate(low, scale_factor=2,
                                           mode="nearest")


class HourglassNet(nn.Module):
    """exkp (reference :189-283)."""

    def __init__(self, heads, num_stacks=2, cnv_dim=256):
        super().__init__()
        self.heads = tuple(sorted(dict(heads).items()))
        self.num_stacks = num_stacks
        curr_dim = DIMS[0]
        self.pre = nn.Sequential(ConvBlock(7, 3, 128, stride=2),
                                 Residual(128, curr_dim, stride=2))
        self.kps = nn.ModuleList(KpModule(5, DIMS, MODULES)
                                 for _ in range(num_stacks))
        self.cnvs = nn.ModuleList(ConvBlock(3, curr_dim, cnv_dim)
                                  for _ in range(num_stacks))
        self.inters = nn.ModuleList(Residual(curr_dim, curr_dim)
                                    for _ in range(num_stacks - 1))
        self.inters_ = nn.ModuleList(
            nn.Sequential(conv(curr_dim, curr_dim), bn(curr_dim))
            for _ in range(num_stacks - 1))
        self.cnvs_ = nn.ModuleList(
            nn.Sequential(conv(cnv_dim, curr_dim), bn(curr_dim))
            for _ in range(num_stacks - 1))
        for name, classes in self.heads:
            setattr(self, name, nn.ModuleList(
                nn.Sequential(ConvBlock(3, cnv_dim, curr_dim, with_bn=False),
                              conv(curr_dim, classes, bias=True))
                for _ in range(num_stacks)))

    @torch.no_grad()
    def reset_parameters(self, generator):
        """The JAX package's initialisers (torch's conv default, zero
        biases, the heatmaps' -2.19), drawn from `generator`."""
        for m in self.modules():
            if isinstance(m, nn.BatchNorm2d):
                m.reset_parameters()
            elif isinstance(m, nn.Conv2d):
                torch_conv_init_(m.weight, generator)
                if m.bias is not None:
                    m.bias.zero_()
        for name, _ in self.heads:
            for stack in getattr(self, name):
                stack[1].bias.fill_(-2.19 if "hm" in name else 0.0)

    def forward(self, images, update_stats=False):
        inter = self.pre(nchw(images))
        outs = []
        for ind in range(self.num_stacks):
            cnv = self.cnvs[ind](self.kps[ind](inter))
            outs.append({name: nhwc(getattr(self, name)[ind](cnv)).float()
                         for name, _ in self.heads})
            if ind < self.num_stacks - 1:
                inter = F.relu(self.inters_[ind](inter)
                               + self.cnvs_[ind](cnv))
                inter = self.inters[ind](inter)
        return outs


def get_large_hourglass_net(num_layers, heads, head_conv=64, qspec=None,
                            dtype=None):
    """hourglass (the JAX package's hourglass.py:165-173): two stacks;
    num_layers and head_conv are not read, as there."""
    del num_layers, head_conv
    if qspec is not None:
        print("warning: quantization is only defined for the shufflenetv2 "
              "arch (reference portable_quantizer); running hourglass FP32")
    return HourglassNet(heads, num_stacks=2)
