"""ShuffleNetV2 + co-designed deformable deconv — the CoDeNet flagship.

PyTorch port of the JAX package's models/shufflenetv2.py (reference
lib/models/networks/shufflenetv2_dcn.py:189-330), FP32. Module names follow
the reference ``state_dict`` layout (the one
JAX package's engine/torch_import.py::convert_shufflenetv2 reads):
``layer0.{0,1}``, ``layerL.k.b1.{0..3}``, ``layerL.k.b2.{0,1,3,4,5,6}``,
``layer4.{0,1}``, ``deconv_layers.{4i}.{conv_scale,conv,conv_channel}``
with its BatchNorm at ``deconv_layers.{4i+1}``, and ``{head}.{0,1,3,4,6}``.

`forward` takes (N, H, W, 3) images and returns {head: (N, H/4, W/4, C)},
NHWC like the JAX model; inside, activations are channels_last NCHW.
"""

from __future__ import annotations

import torch
from torch import nn

from .layers import (CodesignDeformBlock, bn, channel_shuffle, conv,
                     kaiming_normal_relu_, nchw, nhwc, torch_conv_init_)


class BaseNode(nn.Module):
    """ShuffleNetV2 unit (reference shufflenetv2_dcn.py:57-114).

    stride 1: split channels; b2 = pw+BN+ReLU -> dw+BN -> pw+BN+ReLU.
    stride 2: b1 = dw(s2)+BN -> pw+BN+ReLU; b2 = pw+BN+ReLU -> dw(s2)+BN ->
    pw+BN+ReLU. Concat + channel shuffle.
    """

    def __init__(self, inp, oup, stride, deform=False):
        super().__init__()
        if deform:
            raise NotImplementedError(
                "deform_backbone is queued in ROADMAP.md")
        self.stride = stride
        oup_inc = oup // 2
        if stride == 2:
            self.b1 = nn.Sequential(
                conv(inp, inp, 3, 2, 1, groups=inp), bn(inp),
                conv(inp, oup_inc), bn(oup_inc), nn.ReLU(inplace=True))
            b2_in = inp
        else:
            b2_in = oup_inc
        self.b2 = nn.Sequential(
            conv(b2_in, oup_inc), bn(oup_inc), nn.ReLU(inplace=True),
            conv(oup_inc, oup_inc, 3, stride, 1, groups=oup_inc),
            bn(oup_inc),
            conv(oup_inc, oup_inc), bn(oup_inc), nn.ReLU(inplace=True))

    def forward(self, x):
        if self.stride == 1:
            split = x.shape[1] // 2
            x1, x2 = x[:, :split], x[:, split:]
        else:
            x1, x2 = self.b1(x), x
        y = torch.cat([nhwc(x1), nhwc(self.b2(x2))], dim=-1)
        return nchw(channel_shuffle(y, 2))


class PoseShuffleNetV2(nn.Module):
    """Backbone + co-designed deform deconv stage + detection heads.

    heads: {name: classes} or (name, classes) pairs, e.g. {'hm': 20,
    'wh': 2, 'reg': 2}; heads are built in sorted name order.
    """

    def __init__(self, heads, head_conv=64, w2=False, maxpool=False,
                 deform_backbone=False, qspec=None):
        super().__init__()
        if qspec is not None:
            raise NotImplementedError(
                "quantized PoseShuffleNetV2 is queued in ROADMAP.md")
        heads = dict(heads)
        self.heads = tuple(sorted(heads.items()))
        channels = [24, 244, 488, 976, 2153] if w2 \
            else [24, 116, 232, 464, 1024]

        # layer0 (reference :204-212)
        stem = [conv(3, channels[0], 3, 2 if maxpool else 4, 1),
                bn(channels[0]), nn.ReLU(inplace=True)]
        if maxpool:
            stem.append(nn.MaxPool2d(3, 2, 1))
        self.layer0 = nn.Sequential(*stem)

        # stages 1-3, repeats [3, 7, 3] (reference :214-231)
        for idx, repeats in enumerate([3, 7, 3]):
            inp, oup = channels[idx], channels[idx + 1]
            nodes = [BaseNode(inp, oup, 2, deform_backbone)]
            nodes += [BaseNode(oup, oup, 1, deform_backbone)
                      for _ in range(repeats)]
            setattr(self, "layer{}".format(idx + 1), nn.Sequential(*nodes))

        # layer4: 1x1 expand (reference :233-235)
        self.layer4 = nn.Sequential(conv(channels[3], channels[4]),
                                    bn(channels[4]), nn.ReLU(inplace=True))

        # deconv stage: 3 x [codesign deform, BN, ReLU, 2x up]
        # (reference :238-242, 286-312)
        deconv = []
        cin = channels[4]
        for planes in (256, 128, 64):
            deconv += [CodesignDeformBlock(cin, planes), bn(planes),
                       nn.ReLU(inplace=True),
                       nn.Upsample(scale_factor=2, mode="nearest")]
            cin = planes
        self.deconv_layers = nn.Sequential(*deconv)

        # heads (reference :244-271): 1x1+BN+ReLU -> dw3x3+BN+ReLU -> 1x1
        for name, classes in self.heads:
            setattr(self, name, nn.Sequential(
                conv(64, head_conv), bn(head_conv), nn.ReLU(inplace=True),
                conv(head_conv, head_conv, 3, 1, 1, groups=head_conv),
                bn(head_conv), nn.ReLU(inplace=True),
                conv(head_conv, classes, bias=True)))

    @torch.no_grad()
    def reset_parameters(self, generator):
        """The JAX package's initialisers, drawn from `generator`."""
        done = set()
        for m in self.modules():
            if isinstance(m, nn.BatchNorm2d):
                m.reset_parameters()
            elif isinstance(m, CodesignDeformBlock):
                m.reset_parameters(generator)
                done.update(m.modules())
        for name, _ in self.heads:
            head = getattr(self, name)
            init = torch_conv_init_ if "hm" in name else kaiming_normal_relu_
            for idx in (0, 3, 6):
                init(head[idx].weight, generator)
                done.add(head[idx])
            head[6].bias.fill_(-2.19 if "hm" in name else 0.0)
        for m in self.modules():
            if isinstance(m, nn.Conv2d) and m not in done:
                torch_conv_init_(m.weight, generator)

    def forward(self, images):
        x = nchw(images)
        for layer in (self.layer0, self.layer1, self.layer2, self.layer3,
                      self.layer4, self.deconv_layers):
            x = layer(x)
        return {name: nhwc(getattr(self, name)(x)).float()
                for name, _ in self.heads}


def get_shufflenetv2_dcn(num_layers, heads, head_conv=64, w2=False,
                         maxpool=False, deform_backbone=False, qspec=None):
    """Factory (reference shufflenetv2_dcn.py:364-373) with w2/maxpool
    honoured."""
    del num_layers  # the reference ignores it too
    return PoseShuffleNetV2(heads, head_conv=head_conv, w2=w2,
                            maxpool=maxpool,
                            deform_backbone=deform_backbone, qspec=qspec)
