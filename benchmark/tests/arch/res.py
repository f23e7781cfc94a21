"""The plain reference of the program's `res_<depth>` (CenterNet's
msra_resnet PoseResNet, BasicBlock depths 18 and 34): a 7x7 stride-2 stem
with BN, ReLU and a 3x3 stride-2 max pool, four stages of BasicBlocks
(3x3 + BN + ReLU, 3x3 + BN, the input or its 1x1 + BN projection added,
ReLU), three upsampling stages (a 4x4 stride-2 transposed conv to 256
channels, BN, ReLU), and the heads (3x3 conv with bias, ReLU, 1x1 conv
with bias), with the program's state_dict names. FP32 only: the
architecture does not quantize.

A test fixture: an architecture module as a configuration of this
architecture would add it, which the harness finds by its file alone
(the contract: benchmark/reference/arch/__init__.py).

The seeded state: convolutions He-normal over their fan-in, a transposed
conv's fan-in the 2 x 2 taps of each input channel that reach an output
at stride 2, the heatmap's last conv torch's default spread with bias
-2.19, the other biases 0; BN scales 1, shifts 0.
"""

from __future__ import annotations

import math

import torch.nn.functional as F

from benchmark.reference import ops

BLOCKS = {18: (2, 2, 2, 2), 34: (3, 4, 6, 3)}
PLANES = (64, 128, 256, 512)
UP_PLANES = (256, 256, 256)
FAULTS = {"skip_off": "the blocks' residual adds left out"}


def program_args(cfg):
    return []


def _depth(cfg):
    depth = int(cfg["arch"].split("_", 1)[1])
    if depth not in BLOCKS:
        raise ValueError("the reference has BasicBlock depths {} only"
                         .format(sorted(BLOCKS)))
    return depth


def _blocks(cfg):
    """(name, in channels, planes, stride) of every block."""
    out, cin = [], 64
    for s, (planes, n) in enumerate(zip(PLANES, BLOCKS[_depth(cfg)])):
        for b in range(n):
            stride = 2 if s and not b else 1
            out.append(("layer{}.{}".format(s + 1, b), cin, planes, stride))
            cin = planes
    return out


class Net:
    def __init__(self, cfg, quant=None, precision="f32", fault=None):
        if quant is not None:
            raise ValueError("res does not quantize")
        self.cfg = cfg
        self.heads = tuple(sorted(dict(cfg["heads"]).items()))
        self.precision = precision
        self.skip = fault != "skip_off"
        self.bn_momentum = 0.0

    def _conv_bn(self, x, conv, bn, p, b, train, stride=1, padding=0):
        y = ops.conv(x, p[conv + ".weight"], None, stride, padding, 1,
                     self.precision)
        return ops.batch_norm(y, bn, p, b, train, self.bn_momentum)

    def _up(self, x, name, p):
        w = p[name + ".weight"]
        if self.precision == "tf32":
            x, w = ops.tf32_round(x), ops.tf32_round(w)
        return F.conv_transpose2d(x, w, None, 2, 1)

    def forward(self, x, p, b, train=False, update=False):
        y = F.relu(self._conv_bn(x, "conv1", "bn1", p, b, train, 2, 3))
        y = F.max_pool2d(y, 3, 2, 1)
        for name, cin, planes, stride in _blocks(self.cfg):
            pre = name + "."
            z = F.relu(self._conv_bn(y, pre + "conv1", pre + "bn1", p, b,
                                     train, stride, 1))
            z = self._conv_bn(z, pre + "conv2", pre + "bn2", p, b, train,
                              1, 1)
            if pre + "downsample.0.weight" in p:
                y = self._conv_bn(y, pre + "downsample.0",
                                  pre + "downsample.1", p, b, train, stride)
            y = F.relu(z + y if self.skip else z)
        for i in range(len(UP_PLANES)):
            y = self._up(y, "deconv_layers.{}".format(3 * i), p)
            y = F.relu(ops.batch_norm(y, "deconv_layers.{}".format(3 * i + 1),
                                      p, b, train, self.bn_momentum))
        out = {}
        for name, _ in self.heads:
            h = F.relu(ops.conv(y, p[name + ".0.weight"], p[name + ".0.bias"],
                                1, 1, 1, self.precision))
            out[name] = ops.conv(h, p[name + ".2.weight"],
                                 p[name + ".2.bias"], 1, 0, 1,
                                 self.precision)
        return out


def state_shapes(cfg, quant=False):
    if quant:
        raise ValueError("res does not quantize")
    out = {}

    def bn(name, c):
        for k in ("weight", "bias", "running_mean", "running_var"):
            out["{}.{}".format(name, k)] = (c,)
        out[name + ".num_batches_tracked"] = ()
    out["conv1.weight"] = (64, 3, 7, 7)
    bn("bn1", 64)
    for name, cin, planes, stride in _blocks(cfg):
        out[name + ".conv1.weight"] = (planes, cin, 3, 3)
        bn(name + ".bn1", planes)
        out[name + ".conv2.weight"] = (planes, planes, 3, 3)
        bn(name + ".bn2", planes)
        if stride != 1 or cin != planes:
            out[name + ".downsample.0.weight"] = (planes, cin, 1, 1)
            bn(name + ".downsample.1", planes)
    cin = PLANES[-1]
    for i, planes in enumerate(UP_PLANES):
        out["deconv_layers.{}.weight".format(3 * i)] = (cin, planes, 4, 4)
        bn("deconv_layers.{}".format(3 * i + 1), planes)
        cin = planes
    hc = cfg["head_conv"]
    for name, classes in sorted(dict(cfg["heads"]).items()):
        out[name + ".0.weight"] = (hc, cin, 3, 3)
        out[name + ".0.bias"] = (hc,)
        out[name + ".2.weight"] = (classes, hc, 1, 1)
        out[name + ".2.bias"] = (classes,)
    return out


def init(cfg, name, shape):
    base, leaf = name.rsplit(".", 1)
    if len(shape) == 4:
        if base.startswith("deconv_layers."):
            return math.sqrt(2.0 / (shape[0] * 4))
        fan_in = math.prod(shape[1:])
        if base == "hm.2":
            return 1.0 / math.sqrt(3 * fan_in)
        return math.sqrt(2.0 / fan_in)
    if leaf == "bias" and base == "hm.2":
        return -2.19
    if leaf in ("weight", "running_var"):
        return 1.0
    return 0.0
