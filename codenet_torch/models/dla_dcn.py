"""DLA-34 with DCNv2 iterative deep aggregation ("dla" arch, reference
pose_dla_dcn.py), the CLIs' default arch.

PyTorch port of the JAX package's models/dla_dcn.py, FP32 (a QuantSpec
prints a warning, ``dtype`` is not read, as in the JAX package). Beside
dlav0 (dlav0.py, whose base, trees and shared up kernels it reuses), the
up path's projections and nodes are DCN -> BN -> ReLU blocks (pose_dla_dcn
DeformConv :346-360), the nodes SUM the upsampled layer and its
predecessor (IDAUp.forward :382-388), and a last IDA step (``ida_up``)
aggregates the three finest levels into the stride-4 head feature
(DLASeg.forward :470-478).

The JAX package has no converter for this network's reference
checkpoints; module names follow pose_dla_dcn.py as the JAX docstrings
cite it: ``base.*`` as dlav0, ``dla_up.ida_{i}.{proj,node}_{j}.conv``
(the DCN: ``weight``, ``bias``, ``conv_offset_mask``) and ``.actf.0``
(its BN), ``dla_up.ida_{i}.up_{j}``, the same under ``ida_up``, and heads
``{head}.0`` / ``{head}.2``. engine/jax_weights.py maps them onto the JAX
variables.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from .deform_modules import ModulatedDeformConvPack
from .dlav0 import CHANNELS, DLA, SharedUp, ida_plan, reset_dla
from .layers import bn, msra_init_, nchw, nhwc, pose_head, reset_pose_head


class DeformConvBlock(nn.Module):
    """DCN -> BN -> ReLU (reference DeformConv: ``conv``, ``actf.0``)."""

    def __init__(self, cin, cout):
        super().__init__()
        self.actf = nn.Sequential(bn(cout), nn.ReLU(inplace=True))
        self.conv = ModulatedDeformConvPack(cin, cout)

    def forward(self, x):
        return self.actf(self.conv(x))


class IDAUpDCN(nn.Module):
    """IDAUp with DCN projections and nodes and the sum merge (reference
    :363-388): layers[0] passes through; each later layer is projected,
    upsampled and merged into node_i(layer + its predecessor). Returns
    the new list."""

    def __init__(self, out_dim, channels, up_factors):
        super().__init__()
        self.n = len(channels)
        for i in range(1, self.n):
            setattr(self, "proj_{}".format(i),
                    DeformConvBlock(channels[i], out_dim))
            if up_factors[i] > 1:
                setattr(self, "up_{}".format(i),
                        SharedUp(out_dim, up_factors[i]))
            setattr(self, "node_{}".format(i),
                    DeformConvBlock(out_dim, out_dim))

    def forward(self, layers):
        layers = list(layers)
        for i in range(1, self.n):
            y = getattr(self, "proj_{}".format(i))(layers[i])
            up = getattr(self, "up_{}".format(i), None)
            if up is not None:
                y = up(y)
            layers[i] = getattr(self, "node_{}".format(i))(y + layers[i - 1])
        return layers


class DLAUpDCN(nn.Module):
    """DLAUp (reference :391-415): the coarsest-first outputs of its IDA
    steps, finest first."""

    def __init__(self, chans):
        super().__init__()
        self.steps = len(chans) - 1
        for i, (out_dim, cin, ups) in enumerate(ida_plan(chans)):
            setattr(self, "ida_{}".format(i), IDAUpDCN(out_dim, cin, ups))

    def forward(self, layers):
        layers = list(layers)
        out = [layers[-1]]
        for i in range(self.steps):
            j = -i - 2
            layers[j:] = getattr(self, "ida_{}".format(i))(layers[j:])
            out.insert(0, layers[-1])
        return out


class DLASegDCN(nn.Module):
    """DLA base + DCN DLAUp + final IDAUp + heads (reference DLASeg
    :428-478); first_level = log2(down_ratio), last_level = 5."""

    def __init__(self, heads, head_conv=256, down_ratio=4, last_level=5):
        super().__init__()
        self.heads = tuple(sorted(dict(heads).items()))
        self.first_level = int(np.log2(down_ratio))
        self.n_final = last_level - self.first_level
        self.base = DLA()
        chans = CHANNELS[self.first_level:]
        self.dla_up = DLAUpDCN(chans)
        self.ida_up = IDAUpDCN(
            chans[0], list(CHANNELS[self.first_level:last_level]),
            [2 ** i for i in range(self.n_final)])
        for name, classes in self.heads:
            setattr(self, name, pose_head(chans[0], head_conv, classes))

    @torch.no_grad()
    def reset_parameters(self, generator):
        """The JAX package's initialisers, drawn from `generator`."""
        reset_dla(self, generator)
        for name, _ in self.heads:
            reset_pose_head(getattr(self, name), name, generator,
                            msra_init_, msra_init_)

    def forward(self, images, update_stats=False):
        outs = self.dla_up(self.base(nchw(images))[self.first_level:])
        feat = self.ida_up(outs[:self.n_final])[-1]
        return {name: nhwc(getattr(self, name)(feat)).float()
                for name, _ in self.heads}


def get_pose_net(num_layers, heads, head_conv=256, qspec=None, dtype=None,
                 down_ratio=4):
    """dla_34 (the JAX package's dla_dcn.py:136-147)."""
    if num_layers not in (0, 34):
        print("dla_dcn: only dla34 is implemented; got dla{}, using 34"
              .format(num_layers))
    if qspec is not None:
        print("warning: quantization is only defined for the shufflenetv2 "
              "arch (reference portable_quantizer); running dla in FP32")
    return DLASegDCN(heads, head_conv, down_ratio)
