"""ShuffleNetV2 + co-designed deformable deconv — the CoDeNet flagship.

PyTorch port of the JAX package's models/shufflenetv2.py (reference
lib/models/networks/shufflenetv2_dcn.py:189-330), FP32 or W4A8 fake-quant.
Module names follow the reference ``state_dict`` layout (the one the JAX
package's engine/torch_import.py::convert_shufflenetv2 reads):
``layer0.{0,1}``, ``layerL.k.b1.{0..3}``, ``layerL.k.b2.{0,1,3,4,5,6}``,
``layer4.{0,1}``, ``deconv_layers.{4i}.{conv_scale,conv,conv_channel}``
with its BatchNorm at ``deconv_layers.{4i+1}``, and ``{head}.{0,1,3,4,6}``.

With a ``QuantSpec`` the activation quantizers sit where the JAX package
places them (reference quantize_model.py:26-82), as buffers named after
its ``quant_stats`` tree: ``layer0_act``, ``layerL.share_act`` (ONE
quantizer per stage, called at every branch merge in the JAX order),
``layerL.k.{b1_act1,b2_act1,b2_act2}``, ``layer4_act``,
``deconv_layers.{4i}.{scale_act,deform_act}``, ``deconv{i}_act`` and
``{head}.{act1,act2}``. Layer0's weights quantize to 8 bits.

`forward(images, update_stats=False)` takes (N, H, W, 3) images and
returns {head: (N, H/4, W/4, C)}, NHWC like the JAX model; inside,
activations are channels_last NCHW. BN mode follows the module's
train/eval mode in FP32; quantized, BN is always folded and frozen and
`update_stats` alone decides whether the activation ranges move (the JAX
``train=False, update_stats=True`` QAT step). With ``int8_infer`` the
quantizers emit QTensors and every conv after layer0 runs in int8; the
channel split, the stage's concat and shuffle, the stem pool and the 2x
upsamples move int8 values at the quantizer's scale.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.quant import QTensor
from .layers import (CodesignDeformBlock, apply_act, bn, channel_shuffle,
                     conv, conv_bn, conv_q, kaiming_normal_relu_, nchw,
                     nhwc, qt_concat, qt_module, qt_spatial, quant_act,
                     torch_conv_init_)


class BaseNode(nn.Module):
    """ShuffleNetV2 unit (reference shufflenetv2_dcn.py:57-114).

    stride 1: split channels; b2 = pw+BN+ReLU -> dw+BN -> pw+BN+ReLU.
    stride 2: b1 = dw(s2)+BN -> pw+BN+ReLU; b2 = pw+BN+ReLU -> dw(s2)+BN ->
    pw+BN+ReLU. Concat + channel shuffle. Quant placement follows
    QuantBaseNode (quant_modules.py:809-907); the stage's shared quantizer
    takes x2 always and x1 only at stride 2.
    """

    def __init__(self, inp, oup, stride, deform=False, qspec=None):
        super().__init__()
        if deform:
            raise NotImplementedError(
                "deform_backbone is queued in ROADMAP.md")
        self.stride = stride
        self.qspec = qspec
        oup_inc = oup // 2
        if stride == 2:
            self.b1 = nn.Sequential(
                conv(inp, inp, 3, 2, 1, groups=inp), bn(inp),
                conv(inp, oup_inc), bn(oup_inc), nn.ReLU(inplace=True))
            self.b1_act1 = quant_act(qspec)
            b2_in = inp
        else:
            b2_in = oup_inc
        self.b2 = nn.Sequential(
            conv(b2_in, oup_inc), bn(oup_inc), nn.ReLU(inplace=True),
            conv(oup_inc, oup_inc, 3, stride, 1, groups=oup_inc),
            bn(oup_inc),
            conv(oup_inc, oup_inc), bn(oup_inc), nn.ReLU(inplace=True))
        self.b2_act1 = quant_act(qspec)
        self.b2_act2 = quant_act(qspec)

    def forward(self, x, share=None, update=False):
        q = self.qspec
        if self.stride == 1:
            split = (x.values if isinstance(x, QTensor) else x).shape[1] // 2
            x1 = qt_spatial(lambda v: v[:, :split], x)
            x2 = qt_spatial(lambda v: v[:, split:], x)
        else:
            y = conv_bn(self.b1[0], self.b1[1], x, q)
            y = apply_act(self.b1_act1, y, update)
            x1 = F.relu(conv_bn(self.b1[2], self.b1[3], y, q))
            x2 = x
        y = F.relu(conv_bn(self.b2[0], self.b2[1], x2, q))
        y = apply_act(self.b2_act1, y, update)
        y = conv_bn(self.b2[3], self.b2[4], y, q)
        y = apply_act(self.b2_act2, y, update)
        x2 = F.relu(conv_bn(self.b2[5], self.b2[6], y, q))
        if share is not None:
            if self.stride == 2:
                x1 = share(x1, update)
            x2 = share(x2, update)
        y = qt_concat([qt_spatial(nhwc, x1), qt_spatial(nhwc, x2)], -1)
        return qt_spatial(lambda v: nchw(channel_shuffle(v, 2)), y)


class Stage(nn.Sequential):
    """One backbone stage: a stride-2 node + `repeats` stride-1 nodes at
    indices 0..repeats, and in quant mode their shared quantizer
    `share_act` (quantize_model.py:40-51), registered after them."""

    def __init__(self, inp, oup, repeats, deform=False, qspec=None):
        nodes = [BaseNode(inp, oup, 2, deform, qspec)]
        nodes += [BaseNode(oup, oup, 1, deform, qspec)
                  for _ in range(repeats)]
        super().__init__(*nodes)
        self.num_nodes = len(nodes)
        self.share_act = quant_act(qspec)

    def forward(self, x, update=False):
        for i in range(self.num_nodes):
            x = self[i](x, self.share_act, update)
        return x


class Head(nn.Sequential):
    """Detection head (reference shufflenetv2_dcn.py:244-271): 1x1+BN+ReLU
    -> 3x3 depthwise+BN+ReLU -> 1x1 to classes, at indices 0..6; in quant
    mode `act1`/`act2` after each ReLU and the last conv's weight
    fake-quantized."""

    def __init__(self, classes, head_conv, qspec=None):
        super().__init__(
            conv(64, head_conv), bn(head_conv), nn.ReLU(inplace=True),
            conv(head_conv, head_conv, 3, 1, 1, groups=head_conv),
            bn(head_conv), nn.ReLU(inplace=True),
            conv(head_conv, classes, bias=True))
        self.qspec = qspec
        self.act1 = quant_act(qspec)
        self.act2 = quant_act(qspec)

    def forward(self, x, update=False):
        q = self.qspec
        y = F.relu(conv_bn(self[0], self[1], x, q))
        y = apply_act(self.act1, y, update)
        y = F.relu(conv_bn(self[3], self[4], y, q))
        y = apply_act(self.act2, y, update)
        return conv_q(self[6], y, q)


class PoseShuffleNetV2(nn.Module):
    """Backbone + co-designed deform deconv stage + detection heads.

    heads: {name: classes} or (name, classes) pairs, e.g. {'hm': 20,
    'wh': 2, 'reg': 2}; heads are built in sorted name order.
    """

    def __init__(self, heads, head_conv=64, w2=False, maxpool=False,
                 deform_backbone=False, qspec=None):
        super().__init__()
        self.qspec = qspec
        self.maxpool = maxpool
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
        self.layer0_act = quant_act(qspec)

        # stages 1-3, repeats [3, 7, 3] (reference :214-231)
        for idx, repeats in enumerate([3, 7, 3]):
            setattr(self, "layer{}".format(idx + 1),
                    Stage(channels[idx], channels[idx + 1], repeats,
                          deform_backbone, qspec))

        # layer4: 1x1 expand (reference :233-235)
        self.layer4 = nn.Sequential(conv(channels[3], channels[4]),
                                    bn(channels[4]), nn.ReLU(inplace=True))
        self.layer4_act = quant_act(qspec)

        # deconv stage: 3 x [codesign deform, BN, ReLU, 2x up]
        # (reference :238-242, 286-312; quant placement
        # quantize_model.py:70-82)
        deconv = []
        cin = channels[4]
        for i, planes in enumerate((256, 128, 64)):
            deconv += [CodesignDeformBlock(cin, planes, qspec=qspec),
                       bn(planes), nn.ReLU(inplace=True),
                       nn.Upsample(scale_factor=2, mode="nearest")]
            setattr(self, "deconv{}_act".format(i), quant_act(qspec))
            cin = planes
        self.deconv_layers = nn.Sequential(*deconv)

        for name, classes in self.heads:
            setattr(self, name, Head(classes, head_conv, qspec))

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

    def forward(self, images, update_stats=False):
        q = self.qspec
        up = update_stats
        y = F.relu(conv_bn(self.layer0[0], self.layer0[1], nchw(images), q,
                           w_bit=8))
        y = apply_act(self.layer0_act, y, up)
        if self.maxpool:
            y = qt_module(self.layer0[3], y)
        for stage in (self.layer1, self.layer2, self.layer3):
            y = stage(y, up)
        y = F.relu(conv_bn(self.layer4[0], self.layer4[1], y, q))
        y = apply_act(self.layer4_act, y, up)
        for i in range(3):
            block, block_bn = self.deconv_layers[4 * i:4 * i + 2]
            y = F.relu(block(y, block_bn, up))
            y = apply_act(getattr(self, "deconv{}_act".format(i)), y, up)
            y = qt_module(self.deconv_layers[4 * i + 3], y)
        return {name: nhwc(getattr(self, name)(y, up)).float()
                for name, _ in self.heads}


def get_shufflenetv2_dcn(num_layers, heads, head_conv=64, w2=False,
                         maxpool=False, deform_backbone=False, qspec=None):
    """Factory (reference shufflenetv2_dcn.py:364-373) with w2/maxpool
    honoured."""
    del num_layers  # the reference ignores it too
    return PoseShuffleNetV2(heads, head_conv=head_conv, w2=w2,
                            maxpool=maxpool,
                            deform_backbone=deform_backbone, qspec=qspec)
