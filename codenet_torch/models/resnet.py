"""ResNet with transposed-conv (res) or DCNv2 + transposed-conv (resdcn)
upsampling to stride 4, and CenterNet heads.

PyTorch port of the JAX package's models/resnet.py (reference
lib/models/networks/msra_resnet.py PoseResNet and resnet_dcn.py), FP32:
as in the JAX package, quantization is defined for shufflenetv2 only (a
QuantSpec prints a warning and the model runs in FP32) and the convs
ignore ``dtype`` (always f32). Module names follow the reference
``state_dict`` (the layout the JAX package's engine/torch_import.py::
convert_resnet reads): ``conv1``, ``bn1``, ``layer{s}.{b}.{conv,bn}{k}``
and ``.downsample.{0,1}``, ``deconv_layers.{3i, 3i+1}`` (res: transposed
conv, BN) or ``deconv_layers.{6i, 6i+1, 6i+3, 6i+4}`` (resdcn: DCN, BN,
transposed conv, BN), and heads ``{head}.0`` / ``{head}.2``.

`forward(images)` takes (N, H, W, 3) images and returns {head: (N, H/4,
W/4, C)}, NHWC like the JAX model; inside, activations are channels_last
NCHW. BN follows the module's train/eval mode.

With `grid` (--spatial_shard; a data x spatial parallel.DataParallel)
the images are this rank's band of rows (models/shufflenetv2.py says
how): the stem conv, its max pool and layer1-layer4 run on bands
(`layers.run_steps`: every conv and pool that reads across rows takes
its halo first; the blocks' 1x1 stride-2 downsamples read their own
band's rows), their BNs reducing over the grid, and the map is gathered
ahead of the upsampling stages (the transposed convs, and resdcn's
DCNv2s), or ahead of the first stage whose output rows do not split.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .deform_modules import ModulatedDeformConvPack
from .layers import (band_plan, bn, conv, max_pool_rows, nchw, nhwc,
                     normal_init_, pose_head, reset_pose_head, row_window,
                     run_steps, torch_conv_init_)


class BasicBlock(nn.Module):
    """3x3 + BN + ReLU, 3x3 + BN, the (projected) input added, ReLU."""
    expansion = 1

    def __init__(self, inplanes, planes, stride=1, downsample=False):
        super().__init__()
        self.conv1 = conv(inplanes, planes, 3, stride, 1)
        self.bn1 = bn(planes)
        self.conv2 = conv(planes, planes, 3, 1, 1)
        self.bn2 = bn(planes)
        self.downsample = nn.Sequential(
            conv(inplanes, planes, 1, stride), bn(planes)) \
            if downsample else None

    def forward(self, x):
        y = F.relu(self.bn1(self.conv1(x)))
        y = self.bn2(self.conv2(y))
        res = x if self.downsample is None else self.downsample(x)
        return F.relu(y + res)


class Bottleneck(nn.Module):
    """1x1, 3x3 (stride), 1x1 to 4 x planes, each with BN; residual add."""
    expansion = 4

    def __init__(self, inplanes, planes, stride=1, downsample=False):
        super().__init__()
        out = planes * 4
        self.conv1 = conv(inplanes, planes)
        self.bn1 = bn(planes)
        self.conv2 = conv(planes, planes, 3, stride, 1)
        self.bn2 = bn(planes)
        self.conv3 = conv(planes, out)
        self.bn3 = bn(out)
        self.downsample = nn.Sequential(
            conv(inplanes, out, 1, stride), bn(out)) if downsample else None

    def forward(self, x):
        y = F.relu(self.bn1(self.conv1(x)))
        y = F.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        res = x if self.downsample is None else self.downsample(x)
        return F.relu(y + res)


RESNET_SPEC = {
    18: (BasicBlock, [2, 2, 2, 2]),
    34: (BasicBlock, [3, 4, 6, 3]),
    50: (Bottleneck, [3, 4, 6, 3]),
    101: (Bottleneck, [3, 4, 23, 3]),
    152: (Bottleneck, [3, 8, 36, 3]),
}


def conv_transpose_4x4_s2(cin, cout):
    """torch ConvTranspose2d(k=4, s=2, p=1), no bias: 2x the map. Its
    IOHW weight is the JAX package's HWIO kernel transposed (the JAX
    conv_transpose_4x4_s2 flips it inside)."""
    return nn.ConvTranspose2d(cin, cout, 4, 2, 1, bias=False)


@torch.no_grad()
def bilinear_fill_out0_(weight):
    """resnet_dcn's fill_up_weights as the JAX package's _dcn_up_init
    applies it: output channel 0 of every input channel gets the
    bilinear kernel, the rest keep their init. weight: IOHW."""
    kh, kw = weight.shape[2], weight.shape[3]
    f = (kh + 1) // 2
    c = (2 * f - 1 - f % 2) / (2.0 * f)
    i = torch.arange(kh, dtype=torch.float32)
    j = torch.arange(kw, dtype=torch.float32)
    bil = (1 - (i / f - c).abs())[:, None] * (1 - (j / f - c).abs())[None]
    weight[:, 0] = bil.to(weight.device)


class PoseResNet(nn.Module):
    """ResNet stem and stages, then three upsampling stages to stride 4
    and the heads. dcn=False (res): ConvTranspose 4x4 s2 -> BN -> ReLU,
    256 channels each. dcn=True (resdcn, PoseResNetDCN): DCN 3x3 -> BN ->
    ReLU -> ConvTranspose 4x4 s2 -> BN -> ReLU, planes 256, 128, 64."""

    def __init__(self, heads, num_layers=18, head_conv=64, dcn=False):
        super().__init__()
        self.heads = tuple(sorted(dict(heads).items()))
        self.dcn = dcn
        block, layers = RESNET_SPEC[num_layers]
        self.conv1 = conv(3, 64, 7, 2, 3)
        self.bn1 = bn(64)
        inplanes = 64
        for si, (planes, blocks) in enumerate(zip([64, 128, 256, 512],
                                                  layers)):
            stride = 1 if si == 0 else 2
            need_down = stride != 1 or inplanes != planes * block.expansion
            mods = [block(inplanes, planes, stride, need_down)]
            inplanes = planes * block.expansion
            mods += [block(inplanes, planes) for _ in range(1, blocks)]
            setattr(self, "layer{}".format(si + 1), nn.Sequential(*mods))
        deconv = []
        for planes in ((256, 128, 64) if dcn else (256, 256, 256)):
            if dcn:
                deconv += [ModulatedDeformConvPack(inplanes, planes),
                           bn(planes), nn.ReLU(inplace=True)]
                inplanes = planes
            deconv += [conv_transpose_4x4_s2(inplanes, planes), bn(planes),
                       nn.ReLU(inplace=True)]
            inplanes = planes
        self.deconv_layers = nn.Sequential(*deconv)
        for name, classes in self.heads:
            setattr(self, name, pose_head(inplanes, head_conv, classes))

    @torch.no_grad()
    def reset_parameters(self, generator):
        """The JAX package's initialisers, drawn from `generator`."""
        for m in self.modules():
            if isinstance(m, nn.BatchNorm2d):
                m.reset_parameters()
            elif isinstance(m, ModulatedDeformConvPack):
                m.reset_parameters(generator)
            elif isinstance(m, nn.ConvTranspose2d):
                if self.dcn:
                    torch_conv_init_(m.weight, generator)
                    bilinear_fill_out0_(m.weight)
                else:
                    normal_init_(m.weight, 0.001, generator)
            elif isinstance(m, nn.Conv2d):
                torch_conv_init_(m.weight, generator)

        def out_init(name):
            if self.dcn or "hm" in name:
                return torch_conv_init_
            return lambda w, g: normal_init_(w, 0.001, g)
        for name, _ in self.heads:
            reset_pose_head(getattr(self, name), name, generator,
                            torch_conv_init_, out_init(name))

    def _backbone_steps(self):
        """The stem, its max pool and the four stages as steps
        (layers.gather_point)."""
        steps = [(lambda y: F.relu(self.bn1(self.conv1(y))), [self.bn1],
                  (row_window(self.conv1),)),
                 (lambda y: max_pool_rows(y, 3, 2, 1), [], ((3, 2, 1),))]
        for si in range(4):
            stage = getattr(self, "layer{}".format(si + 1))
            steps.append((stage, [stage], ((3, 1 if si == 0 else 2, 1),)))
        return steps

    def forward(self, images, update_stats=False, grid=None,
                full_height=None):
        steps = self._backbone_steps()
        sp, cut = band_plan(self, steps, grid, full_height)
        y = run_steps(steps, nchw(images), sp, cut)[-1]
        y = self.deconv_layers(y)
        return {name: nhwc(getattr(self, name)(y)).float()
                for name, _ in self.heads}


def _fp32_only(arch, qspec):
    if qspec is not None:
        print("warning: quantization is only defined for the shufflenetv2 "
              "arch (reference portable_quantizer); running {} in FP32"
              .format(arch))


def get_pose_net(num_layers, heads, head_conv=64, qspec=None, dtype=None):
    """res_<depth> (the JAX package's resnet.py:265-274); `dtype` is not
    read, as there."""
    _fp32_only("resnet", qspec)
    return PoseResNet(heads, num_layers or 18, head_conv)


def get_pose_net_dcn(num_layers, heads, head_conv=64, qspec=None,
                     dtype=None):
    """resdcn_<depth> (resnet.py:256-263)."""
    _fp32_only("resdcn", qspec)
    return PoseResNet(heads, num_layers or 18, head_conv, dcn=True)
