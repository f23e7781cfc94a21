"""DLA-34 with iterative deep aggregation up to stride 4 (dlav0), and its
pieces shared with the DCN variant (dla_dcn.py).

PyTorch port of the JAX package's models/dlav0.py (reference
lib/models/networks/dlav0.py DLASeg), FP32 (a QuantSpec prints a warning,
``dtype`` is not read, as in the JAX package). Module names follow the
reference ``state_dict`` (the layout the JAX package's engine/
torch_import.py::convert_dlav0 reads): ``base.base_layer.{0,1}``,
``base.level{0,1}.{0,1}``, the trees ``base.level{2..5}.{tree1,tree2,
root,project}...``, ``dla_up.ida_{i}.{proj_j.{0,1}, up_j, node_j.{0,1}}``
and heads ``{head}.0`` / ``{head}.2``.

With `grid` (--spatial_shard; models/shufflenetv2.py says how) the
`DLA` base levels run on bands of the images' rows (`layers.run_steps`;
a Tree's `Root` is a 1x1 conv on a concatenation of one band's maps),
and each level output the neck reads is gathered ahead of `dla_up`; where
a level's output rows stop splitting, the map is gathered there and the
later levels run whole.

The IDA upsamplers are the reference's depthwise ConvTranspose2d(C, C,
2f, stride f, padding f//2, groups=C), bilinear at init. As in the JAX
package, each holds ONE (2f, 2f) plane shared by all channels
(`SharedUp`, its ``weight`` (1, 1, 2f, 2f)), expanded per call, so its
gradient sums over the channels as the JAX broadcast's does.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..parallel.mesh import gather_rows
from .layers import (band_plan, bn, conv, max_pool_rows, msra_init_, nchw,
                     nhwc, normal_init_, pose_head, reset_pose_head,
                     row_window, run_steps)

LEVELS = (1, 1, 1, 2, 2, 1)
CHANNELS = (16, 32, 64, 128, 256, 512)


def bilinear_up_kernel(f):
    """fill_up_weights' bilinear kernel of size 2f (reference :429-438)."""
    k = 2 * f
    fc = math.ceil(k / 2)
    c = (2 * fc - 1 - fc % 2) / (2.0 * fc)
    w = np.zeros((k, k), np.float32)
    for i in range(k):
        for j in range(k):
            w[i, j] = (1 - abs(i / fc - c)) * (1 - abs(j / fc - c))
    return w


class SharedUp(nn.Module):
    """Depthwise f-times transposed conv (the JAX package's depthwise_up)
    with one (2f, 2f) kernel for every channel."""

    def __init__(self, channels, f):
        super().__init__()
        self.channels = channels
        self.f = f
        self.weight = nn.Parameter(torch.empty(1, 1, 2 * f, 2 * f))
        self.reset_parameters()  # bilinear from the start, never garbage

    @torch.no_grad()
    def reset_parameters(self):
        self.weight.copy_(torch.from_numpy(bilinear_up_kernel(self.f)))

    def forward(self, x):
        w = self.weight.expand(self.channels, 1, -1, -1).contiguous()
        return F.conv_transpose2d(x, w, stride=self.f, padding=self.f // 2,
                                  groups=self.channels)


class ConvBnRelu(nn.Sequential):
    """conv (no bias, 'same' padding) + BN + ReLU at indices 0, 1, 2."""

    def __init__(self, cin, cout, kernel=3, stride=1):
        super().__init__(conv(cin, cout, kernel, stride, (kernel - 1) // 2),
                         bn(cout), nn.ReLU(inplace=True))


class DlaBasicBlock(nn.Module):
    """DLA BasicBlock (reference :29-59); the residual comes in."""

    def __init__(self, inplanes, planes, stride=1):
        super().__init__()
        self.conv1 = conv(inplanes, planes, 3, stride, 1)
        self.bn1 = bn(planes)
        self.conv2 = conv(planes, planes, 3, 1, 1)
        self.bn2 = bn(planes)

    def forward(self, x, residual=None):
        if residual is None:
            residual = x
        y = F.relu(self.bn1(self.conv1(x)))
        y = self.bn2(self.conv2(y))
        return F.relu(y + residual)


class Root(nn.Module):
    """Aggregation node (reference :145-163): concat, 1x1 + BN, ReLU."""

    def __init__(self, in_channels, out_channels, residual=False):
        super().__init__()
        self.conv = conv(in_channels, out_channels)
        self.bn = bn(out_channels)
        self.residual = residual

    def forward(self, xs):
        x = self.bn(self.conv(torch.cat(xs, dim=1)))
        if self.residual:
            x = x + xs[0]
        return F.relu(x)


class Tree(nn.Module):
    """Hierarchical aggregation tree (reference :166-219). Its projection
    runs at every level, also where the subtree recomputes its own (the
    reference and the JAX package do the same)."""

    def __init__(self, levels, in_channels, out_channels, stride=1,
                 level_root=False, root_dim=0, root_residual=False):
        super().__init__()
        if root_dim == 0:
            root_dim = 2 * out_channels
        if level_root:
            root_dim += in_channels
        self.levels = levels
        self.stride = stride
        self.level_root = level_root
        if levels == 1:
            self.tree1 = DlaBasicBlock(in_channels, out_channels, stride)
            self.tree2 = DlaBasicBlock(out_channels, out_channels)
            self.root = Root(root_dim, out_channels, root_residual)
        else:
            self.tree1 = Tree(levels - 1, in_channels, out_channels, stride,
                              root_residual=root_residual)
            self.tree2 = Tree(levels - 1, out_channels, out_channels,
                              root_dim=root_dim + out_channels,
                              root_residual=root_residual)
        self.project = nn.Sequential(conv(in_channels, out_channels),
                                     bn(out_channels)) \
            if in_channels != out_channels else None

    def forward(self, x, residual=None, children=None):
        children = [] if children is None else list(children)
        bottom = max_pool_rows(x, self.stride, self.stride) \
            if self.stride > 1 else x
        res = bottom if self.project is None else self.project(bottom)
        if self.level_root:
            children.append(bottom)
        x1 = self.tree1(x, res)
        if self.levels == 1:
            return self.root([self.tree2(x1), x1] + children)
        return self.tree2(x1, None, children + [x1])


class DLA(nn.Module):
    """The DLA-34 base (reference DLA :222-296): the six levels' outputs,
    strides 1 to 32."""

    def __init__(self):
        super().__init__()
        c = CHANNELS
        self.base_layer = ConvBnRelu(3, c[0], 7)
        self.level0 = ConvBnRelu(c[0], c[0])
        self.level1 = ConvBnRelu(c[0], c[1], stride=2)
        for lv in (2, 3, 4, 5):
            setattr(self, "level{}".format(lv),
                    Tree(LEVELS[lv], c[lv - 1], c[lv], 2,
                         level_root=lv != 2))

    def steps(self):
        """The six levels as steps (layers.gather_point); the first runs
        the base layer too. A Tree level's windows: its stride-2 block's
        3x3 (its 2x2 / 2 max pool gives the same rows)."""
        steps = [(lambda y: self.level0(self.base_layer(y)),
                  [self.base_layer, self.level0],
                  (row_window(self.base_layer[0]),
                   row_window(self.level0[0]))),
                 (self.level1, [self.level1], (row_window(self.level1[0]),))]
        for lv in range(2, 6):
            level = getattr(self, "level{}".format(lv))
            steps.append((level, [level], ((3, level.stride, 1),)))
        return steps

    def forward(self, x, sp=None, cut=0, first=0):
        """The levels' outputs from level `first` on, whole; the first
        `cut` levels on bands over `sp` (layers.band_plan), each gathered
        here."""
        outs = run_steps(self.steps(), x, sp, cut)
        return [gather_rows(y, sp) if lv + 1 < cut else y
                for lv, y in enumerate(outs) if lv >= first]


def ida_plan(chans):
    """(out_dim, in_channels, up_factors) of each IDA step of DLAUp
    (reference :500-531): step i aggregates the last i + 2 levels into
    chans[-i - 2] channels."""
    scales = np.array([2 ** i for i in range(len(chans))], int)
    in_channels = list(chans)
    plan = []
    for i in range(len(chans) - 1):
        j = -i - 2
        plan.append((chans[j], list(in_channels[j:]),
                     [int(s) for s in scales[j:] // scales[j]]))
        scales[j + 1:] = scales[j]
        in_channels[j + 1:] = [chans[j] for _ in chans[j + 1:]]
    return plan


class IDAUp(nn.Module):
    """One iterative deep aggregation step (reference :441-497): each
    layer projected (1x1 + BN + ReLU where its channels differ) and
    upsampled, then chained through the 3x3 nodes over concatenations."""

    def __init__(self, out_dim, channels, up_factors):
        super().__init__()
        self.n = len(channels)
        for i, c in enumerate(channels):
            if c != out_dim:
                setattr(self, "proj_{}".format(i), ConvBnRelu(c, out_dim, 1))
            if up_factors[i] > 1:
                setattr(self, "up_{}".format(i),
                        SharedUp(out_dim, up_factors[i]))
        for i in range(1, self.n):
            setattr(self, "node_{}".format(i),
                    ConvBnRelu(2 * out_dim, out_dim))

    def forward(self, layers):
        layers = list(layers)
        for i in range(self.n):
            for part in ("proj", "up"):
                mod = getattr(self, "{}_{}".format(part, i), None)
                if mod is not None:
                    layers[i] = mod(layers[i])
        x, ys = layers[0], []
        for i in range(1, self.n):
            x = getattr(self, "node_{}".format(i))(
                torch.cat([x, layers[i]], dim=1))
            ys.append(x)
        return x, ys


class DLAUp(nn.Module):
    def __init__(self, chans):
        super().__init__()
        self.steps = len(chans) - 1
        for i, (out_dim, cin, ups) in enumerate(ida_plan(chans)):
            setattr(self, "ida_{}".format(i), IDAUp(out_dim, cin, ups))

    def forward(self, layers):
        layers = list(layers)
        for i in range(self.steps):
            x, ys = getattr(self, "ida_{}".format(i))(layers[-i - 2:])
            layers[-i - 1:] = ys
        return x


class DLASeg(nn.Module):
    """DLA-34 + DLAUp + heads (reference DLASeg :534-619)."""

    def __init__(self, heads, head_conv=256, down_ratio=4):
        super().__init__()
        self.heads = tuple(sorted(dict(heads).items()))
        self.first_level = int(np.log2(down_ratio))
        self.base = DLA()
        chans = CHANNELS[self.first_level:]
        self.dla_up = DLAUp(chans)
        for name, classes in self.heads:
            setattr(self, name, pose_head(chans[0], head_conv, classes))

    @torch.no_grad()
    def reset_parameters(self, generator):
        """The JAX package's initialisers, drawn from `generator`."""
        reset_dla(self, generator)
        for name, _ in self.heads:
            out_init = msra_init_ if "hm" in name \
                else (lambda w, g: normal_init_(w, 0.001, g))
            reset_pose_head(getattr(self, name), name, generator,
                            msra_init_, out_init)

    def forward(self, images, update_stats=False, grid=None,
                full_height=None):
        sp, cut = band_plan(self, self.base.steps(), grid, full_height)
        x = self.dla_up(self.base(nchw(images), sp, cut, self.first_level))
        return {name: nhwc(getattr(self, name)(x)).float()
                for name, _ in self.heads}


@torch.no_grad()
def reset_dla(model, generator):
    """BN to (1, 0), every up kernel bilinear, every conv msra, every DCN
    its own init (dla_dcn); the heads are set after this by the caller."""
    done = set()
    for m in model.modules():
        if isinstance(m, nn.BatchNorm2d):
            m.reset_parameters()
        elif isinstance(m, SharedUp):
            m.reset_parameters()
        elif hasattr(m, "conv_offset_mask"):
            m.reset_parameters(generator)
            done.add(m.conv_offset_mask)
        elif isinstance(m, nn.Conv2d) and m not in done:
            msra_init_(m.weight, generator)


def get_pose_net(num_layers, heads, head_conv=256, qspec=None, dtype=None,
                 down_ratio=4):
    """dlav0_34 (the JAX package's dlav0.py:269-280)."""
    if num_layers not in (0, 34):
        print("dlav0: only dla34 is implemented; got dla{}, using 34"
              .format(num_layers))
    if qspec is not None:
        print("warning: quantization is only defined for the shufflenetv2 "
              "arch (reference portable_quantizer); running dlav0 in FP32")
    return DLASeg(heads, head_conv, down_ratio)
