"""CoDeNet's ctdet network, plain: ShuffleNetV2 1x or 2x (stride-4 stem,
stages of 4 / 8 / 4 units, a 1x1 expansion), three co-designed deform
blocks each with a BN, a ReLU and a 2x nearest upsample, and the CenterNet
heads (1x1 + BN + ReLU, depthwise 3x3 + BN + ReLU, 1x1 to the classes),
as CoDeNet's shufflenetv2_dcn.py lays it out, with the same state_dict
names. W4A8 fake-quant (`quant`) places its quantizers where CoDeNet's
quantize_model.py does and folds every BN from its running statistics.

`forward(x, params, buffers, ...)` is functional: parameters and buffers
are dicts of tensors named as the state_dict names them, and the
quantizers' EMA ranges, when `update` is set, are written back into
`buffers`; train-mode BN updates no running statistics (the reference
compares the training step, not its statistics) but in `calibrate`.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from . import ops

STAGE_REPEATS = (3, 7, 3)


def channels(w2):
    return [24, 244, 488, 976, 2153] if w2 else [24, 116, 232, 464, 1024]


class Net:
    """One configuration of the network. quant: None, or a dict with
    w_bit, a_bit, wt_percentile, act_clamp."""

    def __init__(self, heads, w2, head_conv=64, quant=None,
                 precision="f32", unit_relu=True):
        self.heads = tuple(sorted(dict(heads).items()))
        # False leaves out the ReLUs of the backbone's units: a fault that
        # the harness's readings plant in the reference's place
        self.unit_relu = F.relu if unit_relu else (lambda y: y)
        self.ch = channels(w2)
        self.head_conv = head_conv
        self.quant = quant
        self.precision = precision
        # train-mode BN writes momentum x the batch's statistics into the
        # running ones: 0 leaves them as they are, 1 (`calibrate`) takes
        # the batch's
        self.bn_momentum = 0.0

    # -- pieces -----------------------------------------------------------
    def _bn(self, y, name, p, b, train):
        return F.batch_norm(y, b[name + ".running_mean"],
                            b[name + ".running_var"], p[name + ".weight"],
                            p[name + ".bias"], train, self.bn_momentum,
                            1e-5)

    def _conv_bn(self, x, conv, bn, p, b, train, stride=1, padding=0,
                 groups=1, w_bit=None):
        w = p[conv + ".weight"]
        if self.quant is None:
            y = ops.conv(x, w, None, stride, padding, groups, self.precision)
            return self._bn(y, bn, p, b, train)
        wf, bias = ops.fold_bn(w, p[bn + ".weight"], p[bn + ".bias"],
                               b[bn + ".running_mean"],
                               b[bn + ".running_var"])
        wq = ops.fake_quant_weight(wf, w_bit or self.quant["w_bit"],
                                   self.quant["wt_percentile"])
        return ops.conv(x, wq, bias, stride, padding, groups, self.precision)

    def _conv(self, x, conv, p, stride=1, padding=0, groups=1):
        w, bias = p[conv + ".weight"], p.get(conv + ".bias")
        if self.quant is not None:
            w = ops.fake_quant_weight(w, self.quant["w_bit"],
                                      self.quant["wt_percentile"])
        return ops.conv(x, w, bias, stride, padding, groups, self.precision)

    def _act(self, x, name, b, update):
        if self.quant is None:
            return x
        lo, hi = b[name + ".x_min"], b[name + ".x_max"]
        if update:
            lo, hi = ops.ema_range(lo, hi, x)
            b[name + ".x_min"], b[name + ".x_max"] = lo, hi
        return ops.fake_quant_act(x, self.quant["a_bit"], lo, hi,
                                  self.quant["act_clamp"])

    def _unit(self, x, pre, stride, share, p, b, train, up):
        cb = self._conv_bn
        if stride == 1:
            half = x.shape[1] // 2
            x1, x2 = x[:, :half], x[:, half:]
        else:
            c = x.shape[1]
            y = cb(x, pre + "b1.0", pre + "b1.1", p, b, train, 2, 1, c)
            y = self._act(y, pre + "b1_act1", b, up)
            x1 = self.unit_relu(cb(y, pre + "b1.2", pre + "b1.3", p, b,
                                   train))
            x2 = x
        y = self.unit_relu(cb(x2, pre + "b2.0", pre + "b2.1", p, b, train))
        y = self._act(y, pre + "b2_act1", b, up)
        c = y.shape[1]
        y = cb(y, pre + "b2.3", pre + "b2.4", p, b, train, stride, 1, c)
        y = self._act(y, pre + "b2_act2", b, up)
        x2 = self.unit_relu(cb(y, pre + "b2.5", pre + "b2.6", p, b, train))
        if stride == 2:
            x1 = self._act(x1, share, b, up)
        x2 = self._act(x2, share, b, up)
        return ops.channel_shuffle(torch.cat([x1, x2], 1))

    def _deform_block(self, x, i, p, b, train, up):
        pre = "deconv_layers.{}.".format(4 * i)
        bn = "deconv_layers.{}".format(4 * i + 1)
        s = F.hardtanh(self._conv(x, pre + "conv_scale", p), -7.0, 8.0)
        s = self._act(s, pre + "scale_act", b, up)
        w = p[pre + "conv.weight"]
        if self.quant is not None:
            w = ops.fake_quant_weight(w, self.quant["w_bit"],
                                      self.quant["wt_percentile"])
        y = ops.deform(x, s, w)
        y = self._act(y, pre + "deform_act", b, up)
        if pre + "conv_channel.weight" in p:
            return self._conv_bn(y, pre + "conv_channel", bn, p, b, train)
        return self._bn(y, bn, p, b, train and self.quant is None)

    def _head(self, y, name, p, b, train, up):
        hc = self.head_conv
        y = F.relu(self._conv_bn(y, name + ".0", name + ".1", p, b, train))
        y = self._act(y, name + ".act1", b, up)
        y = F.relu(self._conv_bn(y, name + ".3", name + ".4", p, b, train,
                                 1, 1, hc))
        y = self._act(y, name + ".act2", b, up)
        return self._conv(y, name + ".6", p)

    # -- the network --------------------------------------------------------
    def forward(self, x, p, b, train=False, update=False):
        """{head: (N, C, H/4, W/4)} of normalised (N, 3, H, W) images.
        train: BN on batch statistics (FP32 only; quantized, BN is frozen
        and folded); update: the quantizers' EMA ranges take this batch."""
        train = train and self.quant is None
        y = F.relu(self._conv_bn(x, "layer0.0", "layer0.1", p, b, train, 4,
                                 1, w_bit=8))
        y = self._act(y, "layer0_act", b, update)
        for li, repeats in enumerate(STAGE_REPEATS):
            share = "layer{}.share_act".format(li + 1)
            for k in range(repeats + 1):
                y = self._unit(y, "layer{}.{}.".format(li + 1, k),
                               2 if k == 0 else 1, share, p, b, train,
                               update)
        y = F.relu(self._conv_bn(y, "layer4.0", "layer4.1", p, b, train))
        y = self._act(y, "layer4_act", b, update)
        for i in range(3):
            y = F.relu(self._deform_block(y, i, p, b, train, update))
            y = self._act(y, "deconv{}_act".format(i), b, update)
            y = F.interpolate(y, scale_factor=2, mode="nearest")
        return {name: self._head(y, name, p, b, train, update)
                for name, _ in self.heads}


@torch.no_grad()
def calibrate(net, x, params, buffers):
    """`buffers` with every BN's running statistics set to those of the
    batch x (one train-mode forward): a seeded state whose eval-mode and
    folded forwards see the activations of training."""
    out = {k: v.clone() for k, v in buffers.items()}
    net.bn_momentum = 1.0
    try:
        net.forward(x, params, out, train=True)
    finally:
        net.bn_momentum = 0.0
    return out


def state_shapes(heads, w2, head_conv=64, quant=False):
    """{state_dict name: shape} of the network: weights, BN parameters
    and statistics and, quantized, the quantizers' ranges."""
    ch = channels(w2)
    out = {}

    def bn(name, c):
        for k in ("weight", "bias", "running_mean", "running_var"):
            out["{}.{}".format(name, k)] = (c,)
        out[name + ".num_batches_tracked"] = ()

    def act(name):
        if quant:
            out[name + ".x_min"] = (1,)
            out[name + ".x_max"] = (1,)

    out["layer0.0.weight"] = (ch[0], 3, 3, 3)
    bn("layer0.1", ch[0])
    act("layer0_act")
    for li, repeats in enumerate(STAGE_REPEATS):
        cin, cout = ch[li], ch[li + 1]
        half = cout // 2
        for k in range(repeats + 1):
            pre = "layer{}.{}.".format(li + 1, k)
            if k == 0:
                out[pre + "b1.0.weight"] = (cin, 1, 3, 3)
                bn(pre + "b1.1", cin)
                out[pre + "b1.2.weight"] = (half, cin, 1, 1)
                bn(pre + "b1.3", half)
                act(pre + "b1_act1")
            out[pre + "b2.0.weight"] = (half, cin if k == 0 else half, 1, 1)
            bn(pre + "b2.1", half)
            out[pre + "b2.3.weight"] = (half, 1, 3, 3)
            bn(pre + "b2.4", half)
            out[pre + "b2.5.weight"] = (half, half, 1, 1)
            bn(pre + "b2.6", half)
            act(pre + "b2_act1")
            act(pre + "b2_act2")
        act("layer{}.share_act".format(li + 1))
    out["layer4.0.weight"] = (ch[4], ch[3], 1, 1)
    bn("layer4.1", ch[4])
    act("layer4_act")
    cin = ch[4]
    for i, planes in enumerate((256, 128, 64)):
        pre = "deconv_layers.{}.".format(4 * i)
        out[pre + "conv_scale.weight"] = (1, cin, 1, 1)
        out[pre + "conv_scale.bias"] = (1,)
        out[pre + "conv.weight"] = (cin, 1, 3, 3)
        out[pre + "conv_channel.weight"] = (planes, cin, 1, 1)
        act(pre + "scale_act")
        act(pre + "deform_act")
        bn("deconv_layers.{}".format(4 * i + 1), planes)
        act("deconv{}_act".format(i))
        cin = planes
    for name, classes in sorted(dict(heads).items()):
        out[name + ".0.weight"] = (head_conv, 64, 1, 1)
        bn(name + ".1", head_conv)
        out[name + ".3.weight"] = (head_conv, 1, 3, 3)
        bn(name + ".4", head_conv)
        out[name + ".6.weight"] = (classes, head_conv, 1, 1)
        out[name + ".6.bias"] = (classes,)
        act(name + ".act1")
        act(name + ".act2")
    return out
