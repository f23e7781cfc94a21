#!/usr/bin/env python
"""Analytic speed-of-light roofline of the port's ShuffleNetV2-DCN
detector on an NVIDIA H100 (the JAX package's tools_tpu/roofline.py,
rebuilt for the card).

Models every kernel codenet_torch launches for PoseShuffleNetV2 (config
a: 256^2; c: 512^2; d: 512^2 --w2) as the port executes it, row by row,
each row named after the module it models in the ``state_dict`` layout
(``layer0.0``, ``layer2.3.b2.0``, ``deconv_layers.4.conv_scale``,
``hm.3``; the fused heads as ``hm+reg+wh.0``, the parts
models/fused_heads.py concatenates). The useful work is the MAC count
`utils/profile.py::profile_model` gives: `Model.useful_flops / 2` equals
it. Three roofs, at a card's data-sheet peaks (`CARD_PEAKS`):

- tensor cores: the dense and grouped convs (cuDNN, channels_last). An
  f32 conv runs at the TF32 rate: nothing in codenet_torch sets
  ``torch.backends.cudnn.allow_tf32``, so the CLIs run cuDNN's default,
  TF32 allowed. With ``--dtype bf16`` the port rounds each conv's
  operands to bf16 and convolves them in f32 (models/layers.py::conv2d),
  so those convs take the TF32 rate too; a conv given bf16 tensors would
  take the bf16 rate.
- CUDA cores at the f32 rate: the depthwise convs, both co-designed
  deform kernels (ops/deform_cuda.py: FLOPS_PER_OUT per output element
  forward, BWD_FLOPS_PER_ELEM per element of x backward; a fused
  multiply-add counts 2) and every elementwise pass.
- HBM: each input read once and each output written once per kernel.

No fusion is assumed. Every pass the port launches is a row of its own:
the BN module after each conv (eval: x read, y written; train: x read
once more for the batch statistics), F.relu, the deform block's
hardtanh, the nearest 2x upsample, the concatenation and the channel
shuffle's copy closing each ShuffleNet unit; with bf16 each conv's
operand casts (x and the weight to bf16 and back to f32) and, for a conv
with a bias, its result's casts and the f32 bias add; the deform
kernels' bf16 operand casts and the cast of their output back to f32;
with ``--fused_heads`` the concatenations and pads of the heads'
parameters. A train step (`train_rows`) adds each conv's dgrad and wgrad
(each the forward's flops and bytes; none into the images) and bias
gradient, each tail's backward, the deform backward, the gradient sums
where a map feeds two convs, the zero-filled gradients and copies that
the backward of each channel split and of each head's slice of the
fused output makes, and the fused Adam update (parameters, gradients
and both f32 moments read; parameters and moments written). A depthwise
3x3 conv's dgrad and wgrad are one kernel (ops/dwconv_cuda.py): one
`dw_bwd` row, x and dy read and dx written once.

A row's bound is the largest of its three times; the step's bound is the
sum of the rows' (kernels on one stream serialize). The bounds come from
data-sheet peaks, not from a measurement: chip_smoke.py's roofline phase
times every row and the whole forward or step on the card against them.

Not modelled: configs b and e (--maxpool) and the other archs, as in the
JAX tool; a train step's input normalisation and loss; scalar and
parameter-sized bookkeeping (BN's num_batches_tracked, the fused BN's
running statistics copied back to each head, parameter gradients copied
out of the fused concatenations).

Usage: python tools_torch/roofline.py [--res 256] [--batch 128] [--w2]
       [--dtype bf16|f32] [--train] [--fused_heads]
"""

import argparse
import collections
import dataclasses

# a card's rates: HBM bytes/s; FLOP/s of the f32 CUDA cores and of the
# dense TF32 and bf16 tensor cores (NVIDIA data sheets, no sparsity). The
# first key found in the card's name wins; the H100 SXM is the default.
Peaks = collections.namedtuple("Peaks", "key card hbm f32 tf32 bf16")
CARD_PEAKS = [
    Peaks("H200", "NVIDIA H200 SXM", 4.8e12, 67e12, 495e12, 989e12),
    Peaks("H100 NVL", "NVIDIA H100 NVL", 3.9e12, 60e12, 418e12, 835e12),
    Peaks("PCIe", "NVIDIA H100 PCIe", 2.0e12, 51e12, 378e12, 756e12),
    Peaks("H100", "NVIDIA H100 SXM", 3.35e12, 67e12, 495e12, 989e12)]

FLOPS_PER_OUT = 90  # 9 taps x (4 corner mul-adds + 1 tap-weight mul-add)
# backward, per element of x: 9 taps x (4-corner sample 8, g*w 1, 4 col2im
# products and adds 8, dw FMA 2) + 8 off-centre taps x (4-corner d/ds 8,
# ds FMA 2)
BWD_FLOPS_PER_ELEM = 9 * (8 + 1 + 8 + 2) + 8 * (8 + 2)
ITEMSIZE = {"f32": 4, "bf16": 2}


def card_peaks(name):
    """The Peaks of the card called `name` (torch.cuda.get_device_name)."""
    for peaks in CARD_PEAKS:
        if peaks.key in name:
            return peaks
    return CARD_PEAKS[-1]


def deform_fwd_bytes(n, h, w, c, itemsize, w_itemsize=4):
    """What the deform forward must move: x read and the output written
    in x's type, s read in f32, the 3x3 weight read."""
    return 2 * n * h * w * c * itemsize + n * h * w * 4 \
        + 9 * c * w_itemsize


def deform_bwd_bytes(n, h, w, c, itemsize):
    """What the deform backward must move: x, g, s and w read once, dx
    (x's type), ds and dw written once (the zeroing of ds and dw that the
    kernel's atomics need is not counted)."""
    return 3 * n * h * w * c * itemsize + 2 * n * h * w * 4 \
        + 2 * 9 * c * itemsize


def dw_bwd_bytes(n, h, w, c, stride):
    """What the depthwise 3x3 backward must move in f32 (ops/dwconv_cuda.py,
    dx and dW in one pass): x and dy read, dx written, the weight read
    and dW written."""
    ho, wo = (h - 1) // stride + 1, (w - 1) // stride + 1
    return 4 * (2 * n * h * w * c + n * ho * wo * c + 2 * 9 * c)


@dataclasses.dataclass
class Row:
    """One kernel: the module it models, its op and shapes (enough for
    chip_smoke.py to build the op), and its cost at the whole batch.

    Maps are NCHW-logical (channels_last) with `n` images of h x w at the
    op's input and `cin` channels (per part for a `cat`; elements for a
    parameter-sized row, h = w = 1). `dtype` is the operand type: the
    input's, or for a `cast` the type it casts to."""
    name: str
    kind: str
    n: int
    h: int
    w: int
    cin: int
    cout: int = 0
    k: int = 1
    stride: int = 1
    groups: int = 1
    dtype: str = "f32"
    parts: int = 1
    bias: bool = False
    tc_flops: float = 0.0
    cc_ops: float = 0.0
    bytes: float = 0.0
    useful: float = 0.0

    # the fields that say what runs; the others are the module's name and
    # the op's costs
    OP_FIELDS = ("kind", "n", "h", "w", "cin", "cout", "k", "stride",
                 "groups", "dtype", "parts", "bias")

    def op(self):
        """The op and its shapes (OP_FIELDS): rows equal here run the same
        kernel on the same shapes."""
        return tuple(getattr(self, f) for f in self.OP_FIELDS)

    def largest_numel(self):
        """Elements of the largest map or weight the op reads or writes."""
        out = self.n * self.ho * self.wo * self.cout
        if self.kind.startswith("upsample"):  # its output at 2h x 2w
            out = 4 * self.n * self.h * self.w * self.cin
        weight = self.k * self.k * self.cin // self.groups * self.cout \
            if self.kind in ("conv", "dgrad", "wgrad", "bgrad", "dw_bwd") \
            else 0
        return max(self.n * self.h * self.w * self.cin, out, weight)

    @property
    def ho(self):
        return (self.h - 1) // self.stride + 1

    @property
    def wo(self):
        return (self.w - 1) // self.stride + 1

    def times(self, peaks):
        """(tensor-core, CUDA-core, HBM) seconds at `peaks`."""
        tc = peaks.bf16 if self.dtype == "bf16" else peaks.tf32
        return (self.tc_flops / tc, self.cc_ops / peaks.f32,
                self.bytes / peaks.hbm)

    def bound(self, peaks):
        """(seconds, roof): the largest of the three times and its roof."""
        t = self.times(peaks)
        best = max(t)
        return best, ("tensor", "cuda", "hbm")[t.index(best)]


class Model:
    """Accumulates the rows of a forward (and of its backward in
    `backward`, which `train_rows` reads), the useful FLOPs and the
    parameter count.

    Each helper takes a map's (h, w) at its input and returns it at its
    output; `train` makes every BN a train-mode one."""

    def __init__(self, batch, dtype, train=False):
        self.b = batch
        self.dtype = dtype
        self.train = train
        self.rows = []
        self.backward = []
        self.useful_flops = 0.0
        self.params = 0

    def add(self, row, useful=0.0, backward=False):
        (self.backward if backward else self.rows).append(row)
        self.useful_flops += useful
        row.useful = useful
        return row

    def _map(self, name, kind, h, w, c, bytes_per_elem, ops_per_elem=0.0,
             dtype="f32", backward=False, **kw):
        """An elementwise pass over an n x c x h x w map."""
        elems = self.b * h * w * c
        return self.add(Row(name, kind, self.b, h, w, c, c, dtype=dtype,
                            cc_ops=ops_per_elem * elems,
                            bytes=bytes_per_elem * elems, **kw),
                        backward=backward)

    def _elems(self, name, kind, elems, bytes_, dtype="f32", cout=None,
               parts=1, backward=False):
        """A pass over a parameter-sized vector of `elems` elements."""
        return self.add(Row(name, kind, 1, 1, 1, elems,
                            elems if cout is None else cout, dtype=dtype,
                            parts=parts, bytes=bytes_), backward=backward)

    def cast(self, name, hw, c, to, weight=False, backward=True):
        """x.to(to) of a map (or, `weight`, of c elements), and the cast
        its gradient takes back."""
        src = "f32" if to == "bf16" else "bf16"
        per = ITEMSIZE[src] + ITEMSIZE[to]
        if weight:
            self._elems(name, "cast", c, per * c, dtype=to)
            if backward:
                self._elems(name, "cast", c, per * c, dtype=src,
                            backward=True)
            return
        self._map(name, "cast", *hw, c, per, 1.0, dtype=to)
        if backward:
            self._map(name, "cast", *hw, c, per, 1.0, dtype=src,
                      backward=True)

    def conv(self, name, hw, cin, cout, k=1, stride=1, groups=1,
             bias=False, dx=True, params=None, useful=None):
        """A conv (padding k // 2) through models/layers.py::conv2d: with
        bf16 its operands' casts, the f32 conv, and with a bias the
        result's casts and the bias add; dense and grouped convs on the
        tensor cores, depthwise ones (one input channel a group) on the
        CUDA cores. Backward: dgrad (unless `dx` is False: the images),
        wgrad, and with a bias its gradient; for a depthwise 3x3 conv one
        `dw_bwd` row (ops/dwconv_cuda.py's kernel) in their place.
        `params` and `useful` override the counts of a fused conv (padded
        outputs)."""
        h, w = hw
        bf16 = self.dtype == "bf16"
        wel = k * k * cin // groups * cout
        if bf16:
            self.cast(name, hw, cin, "bf16", backward=dx)
            self.cast(name, hw, cin, "f32", backward=dx)
            self.cast(name, hw, wel, "bf16", weight=True)
            self.cast(name, hw, wel, "f32", weight=True)
        row = Row(name, "conv", self.b, h, w, cin, cout, k, stride, groups,
                  bias=bias and not bf16)
        fl = 2.0 * k * k * row.ho * row.wo * cin // groups * cout * self.b
        io = (self.b * h * w * cin + self.b * row.ho * row.wo * cout) * 4
        wbytes = (wel + (cout if bias else 0)) * 4
        dense = cin // groups > 1
        row.tc_flops, row.cc_ops = (fl, 0.0) if dense else (0.0, fl)
        row.bytes = io + wbytes
        self.add(row, fl if useful is None else useful)
        self.params += wel + (cout if bias else 0) if params is None \
            else params
        if k == 3 and groups == cin == cout:
            # the depthwise backward kernel: dx and dW in one pass
            self.add(dataclasses.replace(
                row, kind="dw_bwd", bias=False, cc_ops=2 * fl,
                bytes=dw_bwd_bytes(self.b, h, w, cin, stride)),
                backward=True)
        else:
            for kind in ("dgrad", "wgrad") if dx else ("wgrad",):
                self.add(dataclasses.replace(row, kind=kind, bias=False,
                                             bytes=io + wel * 4),
                         backward=True)
        out = (row.ho, row.wo)
        if bias:
            if bf16:
                self.cast(name, out, cout, "bf16")
                self.cast(name, out, cout, "f32")
                self.cast(name, out, cout, "bf16", weight=True)
                self.cast(name, out, cout, "f32", weight=True)
                self._map(name, "bias_add", *out, cout, 8, 1.0)
            # the bias gradient: dy summed over n, h, w
            self.add(Row(name, "bgrad", self.b, *out, cout, cout,
                         cc_ops=self.b * out[0] * out[1] * cout,
                         bytes=(self.b * out[0] * out[1] + 1) * cout * 4),
                     backward=True)
        return out

    def dwconv(self, name, hw, c, stride=1):
        """Depthwise 3x3 conv (groups = c): CUDA cores and traffic."""
        return self.conv(name, hw, c, c, 3, stride, groups=c)

    def bn(self, name, hw, c):
        """The BN module on an f32 map: eval reads x and writes y; train
        reads x once more (the batch statistics). Backward: the statistics
        of dy and x·dy, then dx (x and dy read twice, dx written)."""
        self.params += 2 * c
        if self.train:
            row = self._map(name, "bn_train", *hw, c, 12, 4.0)
            row.bytes += 8 * c * 4
            self._map(name, "bn_bwd", *hw, c, 20, 6.0, backward=True)
        else:
            row = self._map(name, "bn", *hw, c, 8, 2.0)
            row.bytes += 4 * c * 4
        return hw

    def relu(self, name, hw, c):
        self._map(name, "relu", *hw, c, 8, 1.0)
        self._map(name, "relu_bwd", *hw, c, 12, 1.0, backward=True)
        return hw

    def conv_bn_relu(self, prefix, hw, cin, cout, k=1, stride=1, dx=True):
        """`layers.conv_bn` of modules prefix.{0,1}, then F.relu (the
        nn.ReLU at prefix.2)."""
        hw = self.conv(prefix + ".0", hw, cin, cout, k, stride, dx=dx)
        self.bn(prefix + ".1", hw, cout)
        return self.relu(prefix + ".2", hw, cout)

    def fork(self, name, hw, c, consumers=2):
        """A map read by `consumers` ops: its gradients summed."""
        for _ in range(consumers - 1):
            self._map(name, "grad_add", *hw, c, 12, 1.0, backward=True)

    def split(self, name, hw, c, parts):
        """Channel slices of a map (c channels, `parts` the slices' widths):
        no kernel forward; backward each slice's gradient zero-filled to
        the whole map and copied in, then summed."""
        for part in parts:
            self._map(name, "zeros", *hw, c, 4, backward=True)
            self.add(Row(name, "copy", self.b, *hw, part, c,
                         bytes=self.b * hw[0] * hw[1] * part * 8),
                     backward=True)
        self.fork(name, hw, c, len(parts))

    def unit(self, prefix, hw, cin, c, stride):
        """A ShuffleNetV2 unit (models/shufflenetv2.py::BaseNode)."""
        half = c // 2
        if stride == 2:
            self.fork(prefix, hw, cin)
            y = self.dwconv(prefix + ".b1.0", hw, cin, 2)
            self.bn(prefix + ".b1.1", y, cin)
            self.conv(prefix + ".b1.2", y, cin, half)
            self.bn(prefix + ".b1.3", y, half)
            self.relu(prefix + ".b1.4", y, half)
            b2_in = cin
        else:
            self.split(prefix, hw, c, (half, half))
            b2_in = half
        self.conv(prefix + ".b2.0", hw, b2_in, half)
        self.bn(prefix + ".b2.1", hw, half)
        self.relu(prefix + ".b2.2", hw, half)
        hw = self.dwconv(prefix + ".b2.3", hw, half, stride)
        self.bn(prefix + ".b2.4", hw, half)
        self.conv(prefix + ".b2.5", hw, half, half)
        self.bn(prefix + ".b2.6", hw, half)
        self.relu(prefix + ".b2.7", hw, half)
        # torch.cat of the two halves (NHWC), then channel_shuffle's copy;
        # backward the cat is two views, the shuffle a copy
        self.add(Row(prefix, "cat", self.b, *hw, half, c, parts=2,
                     bytes=self.b * hw[0] * hw[1] * c * 8))
        self._map(prefix, "shuffle", *hw, c, 8)
        self._map(prefix, "shuffle", *hw, c, 8, backward=True)
        return hw

    def deform(self, name, hw, c):
        """The co-designed deform conv of a deconv block (the forward
        kernel; `train_rows` takes the backward kernel): in bf16, x and
        the weight cast to bf16 and the output back to f32."""
        h, w = hw
        bf16 = self.dtype == "bf16"
        if bf16:
            self.cast(name, hw, c, "bf16")
            self.cast(name, hw, 9 * c, "bf16", weight=True)
        dt = self.dtype if bf16 else "f32"
        item = ITEMSIZE[dt]
        elems = self.b * h * w * c
        self.add(Row(name, "deform", self.b, h, w, c, c, 3, dtype=dt,
                     cc_ops=float(elems * FLOPS_PER_OUT),
                     bytes=deform_fwd_bytes(self.b, h, w, c, item)),
                 useful=9 * 2.0 * elems)
        self.add(Row(name, "deform_bwd", self.b, h, w, c, c, 3, dtype=dt,
                     cc_ops=float(elems * BWD_FLOPS_PER_ELEM),
                     bytes=deform_bwd_bytes(self.b, h, w, c, item)),
                 backward=True)
        self.params += 9 * c
        if bf16:
            self.cast(name, hw, c, "f32")

    def upsample(self, name, hw, c):
        """nn.Upsample(scale_factor=2, mode='nearest')."""
        h, w = hw
        self._map(name, "upsample", h, w, c, 20)
        self._map(name, "upsample_bwd", h, w, c, 20, backward=True)
        return 2 * h, 2 * w

    def deconv(self, i, hw, cin, planes):
        """deconv_layers.{4i..4i+3}: the co-designed deform block
        (models/layers.py::CodesignDeformBlock: conv_scale, hardtanh, the
        deform conv, the conv_channel mixer and its BN), ReLU, 2x up."""
        pre = "deconv_layers.%d" % (4 * i)
        self.fork(pre, hw, cin)
        s_hw = self.conv(pre + ".conv_scale", hw, cin, 1, bias=True)
        self._map(pre, "hardtanh", *s_hw, 1, 8, 2.0)
        self._map(pre, "hardtanh_bwd", *s_hw, 1, 12, 2.0, backward=True)
        self.deform(pre + ".conv", hw, cin)
        self.conv(pre + ".conv_channel", hw, cin, planes)
        self.bn("deconv_layers.%d" % (4 * i + 1), hw, planes)
        self.relu("deconv_layers.%d" % (4 * i + 2), hw, planes)
        return self.upsample("deconv_layers.%d" % (4 * i + 3), hw, planes)

    def heads(self, hw, heads, head_conv=64):
        """Per head (sorted names; models/shufflenetv2.py::Head): 1x1 +
        BN + ReLU, depthwise 3x3 + BN + ReLU, 1x1 to its classes with a
        bias; each reads the neck."""
        self.fork("deconv_layers.11", hw, 64, len(heads))
        for name, classes in heads:
            self.conv_bn_relu(name, hw, 64, head_conv)
            self.dwconv(name + ".3", hw, head_conv)
            self.bn(name + ".4", hw, head_conv)
            self.relu(name + ".5", hw, head_conv)
            self.conv(name + ".6", hw, head_conv, classes, bias=True)

    def fused_heads(self, hw, heads, head_conv=64):
        """models/fused_heads.py: the heads' parameters concatenated (and
        the class convs' padded to the largest class count), one 1x1 stem,
        BN, ReLU, one depthwise 3x3, BN, ReLU, one grouped 1x1; each head
        a slice of its output."""
        nh = len(heads)
        hc = head_conv * nh
        cmax = max(c for _, c in heads)
        fused = "+".join(name for name, _ in heads)

        def param_cat(idx, elems):
            self._elems("%s.%s" % (fused, idx), "cat", elems,
                        2 * nh * elems * 4, cout=nh * elems, parts=nh)

        def bn(idx):
            for _ in range(4):  # running mean and variance, weight, bias
                param_cat(idx, head_conv)
            self.bn("%s.%d" % (fused, idx), hw, hc)

        param_cat(0, 64 * head_conv)
        self.conv(fused + ".0", hw, 64, hc)
        bn(1)
        self.relu(fused + ".2", hw, hc)
        param_cat(3, 9 * head_conv)
        self.dwconv(fused + ".3", hw, hc)
        bn(4)
        self.relu(fused + ".5", hw, hc)
        for name, classes in heads:
            for elems in (classes * head_conv, classes):
                scale = elems // classes
                self._elems(name + ".6", "pad", elems,
                            (elems + cmax * scale) * 4, cout=cmax * scale)
        param_cat(6, cmax * head_conv)
        param_cat(6, cmax)
        real = sum(c for _, c in heads)
        self.conv(fused + ".6", hw, hc, cmax * nh, groups=nh, bias=True,
                  params=real * (head_conv + 1),
                  useful=2.0 * hw[0] * hw[1] * head_conv * real * self.b)
        self.split(fused + ".6", hw, cmax * nh,
                   [c for _, c in heads])

    def adam(self):
        """torch.optim.Adam(fused=True) over every parameter: parameters,
        gradients and both f32 moments read; parameters and moments
        written."""
        return Row("optimizer", "adam", 1, 1, 1, self.params, self.params,
                   cc_ops=16.0 * self.params, bytes=28.0 * self.params)


def build(res=256, w2=False, batch=128, dtype="bf16", heads=None,
          fused_heads=False, train=False):
    """The rows of PoseShuffleNetV2's forward at res^2 (w2: the 2x
    network), in the order the port launches them; `train` for the
    forward of a train step (BN on batch statistics), whose backward
    `train_rows` adds."""
    heads = sorted(dict(heads or {"hm": 20, "wh": 2, "reg": 2}).items())
    ch = [24, 244, 488, 976, 2153] if w2 else [24, 116, 232, 464, 1024]
    m = Model(batch, dtype, train)

    hw = m.conv_bn_relu("layer0", (res, res), 3, ch[0], 3, 4, dx=False)
    for si, reps in enumerate([3, 7, 3]):
        pre = "layer%d" % (si + 1)
        hw = m.unit(pre + ".0", hw, ch[si], ch[si + 1], 2)
        for r in range(reps):
            hw = m.unit("%s.%d" % (pre, r + 1), hw, ch[si + 1],
                        ch[si + 1], 1)
    hw = m.conv_bn_relu("layer4", hw, ch[3], ch[4])

    cin = ch[4]
    for i, planes in enumerate((256, 128, 64)):
        hw = m.deconv(i, hw, cin, planes)
        cin = planes
    assert hw == (res // 4, res // 4)
    if fused_heads:
        m.fused_heads(hw, heads)
    else:
        m.heads(hw, heads)
    return m


def train_rows(m):
    """The rows a train step adds to the forward of `build(...,
    train=True)`: the backward of every row (in launch order, last layer
    first) and the Adam update."""
    return list(reversed(m.backward)) + [m.adam()]


def report(m, label, extra_rows=()):
    """Print every row's costs, times and bound at the default card's
    peaks, then the totals."""
    peaks = CARD_PEAKS[-1]
    print("== %s ==" % label)
    print("peaks: %s (data sheet): %.2f TB/s HBM, %.0f TFLOP/s f32, %.0f "
          "TF32, %.0f bf16" % (peaks.card, peaks.hbm / 1e12,
                               peaks.f32 / 1e12, peaks.tf32 / 1e12,
                               peaks.bf16 / 1e12))
    print("%-30s %-12s %9s %9s %9s  %8s %8s %8s  %8s %s"
          % ("row", "kind", "GFLOP_tc", "Gop_cuda", "MB", "t_tc", "t_cuda",
             "t_hbm", "t_SoL", "roof"))
    rows = list(m.rows) + list(extra_rows)
    tot = [0.0, 0.0, 0.0, 0.0]
    for r in rows:
        t = r.times(peaks)
        bound, roof = r.bound(peaks)
        for j, v in enumerate((r.tc_flops, r.cc_ops, r.bytes, bound)):
            tot[j] += v
        print("%-30s %-12s %9.3f %9.3f %9.2f  %8.4f %8.4f %8.4f  %8.4f %s"
              % (r.name, r.kind, r.tc_flops / 1e9, r.cc_ops / 1e9,
                 r.bytes / 1e6, t[0] * 1e3, t[1] * 1e3, t[2] * 1e3,
                 bound * 1e3, roof))
    print("%-43s %9.2f %9.2f %9.1f  %26s  %8.3f ms"
          % ("TOTAL (%d kernels)" % len(rows), tot[0] / 1e9, tot[1] / 1e9,
             tot[2] / 1e6, "", tot[3] * 1e3))
    executed = sum(r.tc_flops + r.cc_ops for r in m.rows if r.useful)
    deform = [r for r in m.rows if r.kind == "deform"]
    print("useful GFLOP (forward, profile_model's MACs x 2): %.2f  -> "
          "executed/useful = %.2fx (forward convs and deform; the deform "
          "kernels alone %.1fx)"
          % (m.useful_flops / 1e9, executed / max(m.useful_flops, 1),
             sum(r.cc_ops for r in deform) / sum(r.useful for r in deform)))
    print("SoL img/s at batch %d: %.0f" % (m.b, m.b / tot[3]))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--res", type=int, default=256)
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--w2", action="store_true")
    ap.add_argument("--dtype", default="bf16", choices=["bf16", "f32"])
    ap.add_argument("--train", action="store_true")
    ap.add_argument("--fused_heads", action="store_true",
                    help="model the fused heads (models/fused_heads.py: "
                         "the served paths' and the train step's default)")
    a = ap.parse_args(argv)
    m = build(res=a.res, w2=a.w2, batch=a.batch, dtype=a.dtype,
              fused_heads=a.fused_heads, train=a.train)
    label = "%d^2 %s b%d %s%s" % (a.res, "w2" if a.w2 else "w1", a.batch,
                                  a.dtype,
                                  " fused heads" if a.fused_heads else "")
    if a.train:
        report(m, label + " TRAIN (fwd + bwd + Adam)",
               extra_rows=train_rows(m))
    else:
        report(m, label + " INFER (decode excluded)")


if __name__ == "__main__":
    main()
