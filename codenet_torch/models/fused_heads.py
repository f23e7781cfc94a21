"""The heads of PoseShuffleNetV2 as one widened pipeline (the JAX
package's models/fused_heads.py).

Per head the model runs 1x1 (64 -> head_conv) + BN + ReLU -> depthwise
3x3 + BN + ReLU -> 1x1 to its classes (models/shufflenetv2.py::Head), and
each stem reads the whole neck. Fused, the H heads are one 1x1 stem (64
-> head_conv * H), one BN and ReLU over the concatenated channels, one
depthwise 3x3 over them, one BN and ReLU, and one grouped 1x1 whose
groups emit the largest class count (the smaller heads' kernels and
biases padded with zeros), sliced back per head. The neck is read once.

Concatenating output channels changes no dot product, and BatchNorm is
per channel, so the fusion computes what the per-head path computes: the
BN stays the separate f32 step after each conv that `conv_bn` runs
(torch's batch_norm over the concatenated statistics, never folded into
the kernel), and with a compute dtype the operands round where
`layers.conv2d` rounds them. The weights are the unchanged per-head
parameters, concatenated on the fly: the ``state_dict`` layout does not
change.

`apply_fused_heads` is the eval form (running statistics);
`apply_fused_heads_train` the train form: batch statistics, by the BN the
heads' modules run (torch's, or the global-batch `_GlobalBatchNorm` under
data parallelism), with the running statistics written back into each
head's own buffers (momentum 0.1, unbiased running variance). FP32 and
bf16 only: with a ``QuantSpec`` `can_fuse_heads` is False and the
per-head path runs (each head keeps its own activation ranges).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .layers import _GlobalBatchNorm, conv2d, nhwc


def can_fuse_heads(model, qspec=None):
    """Only PoseShuffleNetV2's heads fuse, and only outside quant modes."""
    from .shufflenetv2 import PoseShuffleNetV2
    return isinstance(model, PoseShuffleNetV2) and qspec is None \
        and model.qspec is None


def _heads(model):
    return [(getattr(model, name), classes) for name, classes in model.heads]


def _cat(tensors):
    return torch.cat(list(tensors))


def _class_conv(heads):
    """The grouped class conv's (H * cmax, head_conv, 1, 1) kernel and
    (H * cmax,) bias: each head's, padded with zeros to cmax outputs."""
    cmax = max(c for _, c in heads)
    kernels, biases = [], []
    for head, c in heads:
        w, b = head[6].weight, head[6].bias
        kernels.append(F.pad(w, (0, 0, 0, 0, 0, 0, 0, cmax - c)))
        biases.append(F.pad(b, (0, cmax - c)))
    return _cat(kernels), _cat(biases), cmax


def _bn_eval(y, bns):
    return F.batch_norm(y, _cat(m.running_mean for m in bns),
                        _cat(m.running_var for m in bns),
                        _cat(m.weight for m in bns),
                        _cat(m.bias for m in bns), False, 0.0, bns[0].eps)


def _bn_train(y, bns):
    """Train-mode BN over the concatenated channels on batch statistics;
    each head's running statistics take their slice of the update."""
    running_mean = _cat(m.running_mean for m in bns)
    running_var = _cat(m.running_var for m in bns)
    weight = _cat(m.weight for m in bns)
    bias = _cat(m.bias for m in bns)
    first = bns[0]
    if first.dp is None:
        out = F.batch_norm(y, running_mean, running_var, weight, bias, True,
                           first.momentum, first.eps)
    else:
        out = _GlobalBatchNorm.apply(y, weight, bias, running_mean,
                                     running_var, first.eps, first.momentum,
                                     first.dp)
    with torch.no_grad():
        lo = 0
        for m in bns:
            hi = lo + m.num_features
            m.running_mean.copy_(running_mean[lo:hi])
            m.running_var.copy_(running_var[lo:hi])
            m.num_batches_tracked.add_(1)
            lo = hi
    return out


def _fused(model, neck, bn):
    heads = _heads(model)
    dt = model.dtype
    hc = heads[0][0][0].out_channels
    y = conv2d(neck, _cat(h[0].weight for h, _ in heads), None, dt)
    y = F.relu(bn(y, [h[1] for h, _ in heads]))
    y = conv2d(y, _cat(h[3].weight for h, _ in heads), None, dt, padding=1,
               groups=hc * len(heads))
    y = F.relu(bn(y, [h[4] for h, _ in heads]))
    kernel, bias, cmax = _class_conv(heads)
    out = nhwc(conv2d(y, kernel, bias, dt, groups=len(heads))).float()
    return {name: out[..., i * cmax:i * cmax + c]
            for i, (name, c) in enumerate(model.heads)}


def apply_fused_heads(model, neck):
    """{name: (N, H, W, classes) f32} of the neck `model(images,
    return_neck=True)` gives: the per-head outputs of the model in eval
    mode (BN on running statistics)."""
    return _fused(model, neck, _bn_eval)


def apply_fused_heads_train(model, neck):
    """The train form: BN on batch statistics, each head's running
    statistics and batch count updated as its own BN modules would."""
    return _fused(model, neck, _bn_train)


def eval_forward(model, images, qspec=None):
    """Eval-mode forward returning the last stack's head dict: through the
    fused heads where the model fuses, else the model's own forward (the
    detectors' forward)."""
    if can_fuse_heads(model, qspec):
        return apply_fused_heads(model, model(images, return_neck=True))
    out = model(images)
    return out[-1] if isinstance(out, (list, tuple)) else out
