"""Shared layers: layout helpers, shuffle-unit pieces, init functions and
the co-designed deformable block.

Inside the network activations are NCHW-logical tensors in
``torch.channels_last`` memory format, so ``nhwc(x)`` is a free view of
the (N, H, W, C) C-contiguous buffer the deform kernel reads. The public
helpers here keep the JAX package's NHWC layout.

Conv + BN pairs are plain ``nn.Conv2d`` (no bias) + ``BatchNorm2d``
(``nn.BatchNorm2d``, momentum 0.1, eps 1e-5: torch semantics, as the JAX
``ConvBN`` mirrors) placed at the reference ``nn.Sequential`` indices by
the model, so the ``state_dict`` has the reference CoDeNet names. Under
data parallelism (`set_data_parallel`) each train-mode BatchNorm takes
the statistics of the global batch, as flax's BN does over a sharded
batch, and each ``QuantAct`` the global activation range. Inside
`row_sharded` (--spatial_shard) each map is this rank's band of rows, and
every conv and max pool that reads across rows takes its halo from its
neighbours first (parallel/mesh.py::halo_rows).

Quantized (W4A8 fake-quant) execution follows the JAX package's layers.py:
one module tree for both modes, selected by a ``QuantSpec`` (None = FP32).
``conv_bn`` folds each BN from its running statistics into the conv and
fake-quantizes the folded weight (BN frozen, whatever the module's
train/eval mode); ``QuantAct`` holds the activation-range EMA in buffers
(the JAX ``quant_stats`` collection) and updates it only when called with
``update=True``, a flag of its own.

Real-int8 execution (``QuantSpec.int8_infer``, the JAX package's int8
branches): each ``QuantAct`` emits a ``QTensor``; a conv that receives one
folds its BN, takes integer weights (`resolve_int8_weights`) and runs
`int8_conv`; the deform block dequantizes its input and samples in bf16.
Integer weights are derived on the fly from the float ones, or set on
each conv module as non-persistent ``deploy_*`` buffers (engine/w4a8.py:
from a W4A8 artifact, or derived once for serving): no ``state_dict``
carries them.

The compute dtype (``dtype``: None for f32, or ``torch.bfloat16``, the
JAX ``--dtype bfloat16``) is the type of the operands of every conv and of
the deform op, rounded as the JAX layers are once XLA has compiled them
(XLA keeps the excess precision of a bf16 result that is widened again;
measured on the CPU, jitted against op by op): each conv rounds its input
and weight to bf16 and sums their products in f32; a conv followed by a
BN keeps that f32 result, one with a bias rounds it to bf16 and adds the
bf16 bias in f32. The deform op samples bf16 x with the bf16 weight and
its bf16 output is widened. Everything else (BN, activations,
quantizers) is f32. Parameters, buffers and optimizer state stay f32.
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import math

import torch
import torch.nn.functional as F
from torch import nn

from ..ops import quant as Q
from ..ops.deform_conv import codesign_deform_conv
from ..ops.deform_cuda import codesign_deform_conv_fast
from ..parallel.mesh import all_gather_rows, all_sum, halo_rows

# int8 eval samples the deform conv in bf16 (the JAX package's
# layers.py:562-574): its input holds 2^a_bit levels and `deform_act`
# requantizes the output. Checks of the integer path alone set it to f32.
INT8_SAMPLE_DTYPE = torch.bfloat16


def nhwc(x):
    """(N, C, H, W) channels_last -> (N, H, W, C) view."""
    return x.permute(0, 2, 3, 1)


def nchw(x):
    """(N, H, W, C) -> (N, C, H, W) view (channels_last if x is
    contiguous)."""
    return x.permute(0, 3, 1, 2)


# the spatial group whose ranks each hold a band of the current map's
# rows (parallel/mesh.py), inside `row_sharded`; None outside
_ROWS = contextvars.ContextVar("row_shard", default=None)


@contextlib.contextmanager
def row_sharded(sp):
    """Within the block, the convs (`conv_bn`, `conv_q`) and `pool_rows`
    read maps split over the spatial group `sp` (None: whole maps)."""
    token = _ROWS.set(sp)
    try:
        yield
    finally:
        _ROWS.reset(token)


def pool_rows(pool, x):
    """`pool` (an nn.MaxPool2d) on x, a QTensor's values included
    (`qt_module`); inside `row_sharded`, on this rank's band, its halo
    filled with -inf beyond the image."""
    sp = _ROWS.get()
    if sp is None:
        return qt_module(pool, x)
    k, stride, pad = pool.kernel_size, pool.stride, pool.padding
    x = halo_rows(x, sp, k, stride, pad, fill=float("-inf"))
    return F.max_pool2d(x, k, stride, (0, pad))


def max_pool(x, window=3, stride=2, padding=1):
    """Max pooling, NHWC (torch nn.MaxPool2d semantics)."""
    return nhwc(F.max_pool2d(nchw(x), window, stride, padding))


def upsample_nearest_2x(x):
    """2x nearest-neighbour upsample, NHWC (nn.Upsample(scale_factor=2))."""
    return nhwc(F.interpolate(nchw(x), scale_factor=2, mode="nearest"))


def channel_shuffle(x, groups=2):
    """ShuffleNet channel shuffle, NHWC (reference shufflenetv2_dcn.py:
    29-34). Returns a C-contiguous tensor."""
    n, h, w, c = x.shape
    x = x.reshape(n, h, w, groups, c // groups).transpose(3, 4)
    return x.reshape(n, h, w, c)


# -- init functions (the JAX package's layers.py:145-173) ------------------

def _fan_in(weight):
    """OIHW weight: kh * kw * Cin/groups."""
    return weight[0].numel()


@torch.no_grad()
def torch_conv_init_(weight, generator):
    """torch nn.Conv2d default (kaiming_uniform a=sqrt(5)):
    U(+-1/sqrt(fan_in))."""
    bound = 1.0 / math.sqrt(_fan_in(weight))
    return weight.uniform_(-bound, bound, generator=generator)


@torch.no_grad()
def kaiming_normal_relu_(weight, generator):
    """kaiming_normal_(nonlinearity='relu'): normal(0, sqrt(2/fan_in))."""
    std = math.sqrt(2.0 / _fan_in(weight))
    return weight.normal_(0.0, std, generator=generator)


@torch.no_grad()
def deform_weight_init_(weight, in_channels, generator):
    """DeformConv.reset_parameters (modules/dcn_deform_conv.py:49-54):
    U(+-1/sqrt(in_channels * kh * kw)) — full in_channels, not per group."""
    kh, kw = weight.shape[2], weight.shape[3]
    bound = 1.0 / math.sqrt(in_channels * kh * kw)
    return weight.uniform_(-bound, bound, generator=generator)


@torch.no_grad()
def normal_init_(weight, std, generator):
    """normal(0, std): the JAX package's head and deconv inits."""
    return weight.normal_(0.0, std, generator=generator)


@torch.no_grad()
def msra_init_(weight, generator):
    """DLA's init, normal(0, sqrt(2/fan_out)), fan_out = kh * kw * Cout
    (the JAX package's dlav0.py::_msra_init)."""
    n = weight.shape[0] * weight.shape[2] * weight.shape[3]
    return weight.normal_(0.0, math.sqrt(2.0 / n), generator=generator)


def pose_head(cin, head_conv, classes):
    """A CenterNet head of the resnet, dla and dlav0 networks: 3x3 conv +
    ReLU + 1x1 conv to classes (``{head}.0``, ``{head}.2``), or one 1x1
    conv (``{head}``) when head_conv is 0."""
    if head_conv > 0:
        return nn.Sequential(conv(cin, head_conv, 3, 1, 1, bias=True),
                             nn.ReLU(inplace=True),
                             conv(head_conv, classes, bias=True))
    return conv(cin, classes, bias=True)


@torch.no_grad()
def reset_pose_head(head, name, generator, conv1_init, out_init):
    """Init a `pose_head`: its convs with `conv1_init` / `out_init`
    (callables (weight, generator)), biases 0 but the heatmap's -2.19;
    a one-conv head takes `conv1_init`."""
    convs = [head[0], head[2]] if isinstance(head, nn.Sequential) \
        else [head]
    inits = [conv1_init, out_init] if len(convs) == 2 else [conv1_init]
    for m, init in zip(convs, inits):
        init(m.weight, generator)
        m.bias.zero_()
    convs[-1].bias.fill_(-2.19 if "hm" in name else 0.0)


def conv(cin, cout, kernel_size=1, stride=1, padding=0, groups=1,
         bias=False):
    return nn.Conv2d(cin, cout, kernel_size, stride, padding, groups=groups,
                     bias=bias)


class _GlobalBatchNorm(torch.autograd.Function):
    """Train-mode BN over the batch of every rank of `dp`.

    Forward: each rank's per-channel (mean, biased variance, count) are
    gathered and combined (Chan's pairwise update: exact, and no E[x^2] -
    E[x]^2 cancellation); the running statistics take the global mean
    and the global variance made unbiased over the global count, as
    torch's BN does over one batch. Backward: the per-channel sums of dy
    and dy * (x - mean) are all-reduced into dx; the weight's and bias's
    gradients stay this rank's share (the trainer sums gradients over the
    ranks)."""

    @staticmethod
    def forward(ctx, x, weight, bias, running_mean, running_var, eps,
                momentum, dp):
        c = x.shape[1]
        var, mean = torch.var_mean(x, dim=(0, 2, 3), unbiased=False)
        rows = all_gather_rows(torch.cat(
            [mean, var, mean.new_full((1,), x.numel() // c)]), dp)
        counts = rows[:, -1:]
        total = counts.sum()
        g_mean = (counts * rows[:, :c]).sum(0) / total
        g_var = (counts * (rows[:, c:2 * c]
                           + (rows[:, :c] - g_mean) ** 2)).sum(0) / total
        with torch.no_grad():
            running_mean.mul_(1.0 - momentum).add_(momentum * g_mean)
            running_var.mul_(1.0 - momentum).add_(
                momentum * g_var * (total / (total - 1.0)))
        ctx.save_for_backward(x, weight, g_mean, torch.rsqrt(g_var + eps))
        ctx.total, ctx.dp = total, dp
        return F.batch_norm(x, g_mean, g_var, weight, bias, False, 0.0, eps)

    @staticmethod
    def backward(ctx, dy):
        x, weight, mean, invstd = ctx.saved_tensors
        c = x.shape[1]

        def chan(v):
            return v[None, :, None, None]
        xmu = x - chan(mean)
        local = torch.cat([dy.sum((0, 2, 3)), (dy * xmu).sum((0, 2, 3))])
        glob = all_sum(local, ctx.dp) / ctx.total
        dx = (dy - chan(glob[:c])
              - xmu * chan(invstd * invstd * glob[c:])) * chan(invstd
                                                                 * weight)
        return (dx, local[c:] * invstd, local[:c], None, None, None, None,
                None)


class BatchNorm2d(nn.BatchNorm2d):
    """``nn.BatchNorm2d`` that, in train mode with `dp` set (a
    parallel.DataParallel, by `set_data_parallel`), normalises with the
    statistics of the global batch (`_GlobalBatchNorm`). Same parameters,
    buffers and names."""
    dp = None

    def forward(self, x):
        if self.dp is None or not self.training:
            return super().forward(x)
        self.num_batches_tracked.add_(1)
        return _GlobalBatchNorm.apply(x, self.weight, self.bias,
                                      self.running_mean, self.running_var,
                                      self.eps, self.momentum, self.dp)


def bn(c):
    return BatchNorm2d(c, eps=1e-5, momentum=0.1)


def set_data_parallel(model, dp):
    """Make every BatchNorm and QuantAct of `model` reduce over the ranks
    of `dp` (None: this process's batch alone)."""
    for m in model.modules():
        if isinstance(m, (BatchNorm2d, QuantAct)):
            m.dp = dp


# -- quantized execution (the JAX package's layers.py:121-143, 267-508) ----

@dataclasses.dataclass(frozen=True)
class QuantSpec:
    """Static quantization configuration (reference quantize_model.py:
    7-24). act_clamp: clamp fake-quantized activations to the signed int8
    window, as real int8 storage does (the reference does not)."""
    w_bit: int = 4
    a_bit: int = 8
    wt_percentile: bool = False
    act_percentile: bool = False
    int8_infer: bool = False
    act_clamp: bool = False


def qspec_from_opt(opt):
    """The W4A8 recipe of the command-line flags (the JAX package's
    cli/quant_main.py and detector: symmetric per-channel weights,
    asymmetric activations)."""
    return QuantSpec(w_bit=opt.w_bit, a_bit=opt.a_bit,
                     wt_percentile=opt.wt_percentile,
                     act_percentile=opt.act_percentile,
                     int8_infer=opt.int8_infer, act_clamp=opt.act_clamp)


class QuantAct(nn.Module):
    """EMA-range activation fake-quantizer (reference QuantAct,
    quant_modules.py:163-225). `x_min`/`x_max` are buffers; with
    update=True the EMA takes this batch's range before quantizing: the
    range of the global batch under data parallelism (`dp`)."""
    dp = None

    def __init__(self, qspec):
        super().__init__()
        self.qspec = qspec
        self.register_buffer("x_min", torch.zeros(1))
        self.register_buffer("x_max", torch.zeros(1))

    def forward(self, x, update=False):
        q = self.qspec
        if update and q.int8_infer:
            raise ValueError("int8 inference runs with frozen activation "
                             "ranges")
        if update:
            with torch.no_grad():
                bmin, bmax = Q.act_range_observe(x, q.act_percentile,
                                                 self.dp)
                nmin, nmax = Q.ema_update(self.x_min, self.x_max, bmin,
                                          bmax)
                self.x_min.copy_(nmin)
                self.x_max.copy_(nmax)
        if q.int8_infer:
            return Q.quantize_act_int8(x.float(), q.a_bit, self.x_min,
                                       self.x_max)
        out = Q.fake_quant_act(x.float(), q.a_bit, self.x_min, self.x_max,
                               clamp=q.act_clamp)
        return out.to(x.dtype)


def quant_act(qspec):
    """A QuantAct, or None in FP32 (no buffers, FP32 state_dict as is)."""
    return QuantAct(qspec) if qspec is not None else None


def apply_act(act, x, update):
    return x if act is None else act(x, update)


def fake_quant(weight, qspec, w_bit=None):
    return Q.fake_quant_weight(weight, w_bit or qspec.w_bit,
                               qspec.wt_percentile)


# -- real-int8 execution (the JAX package's layers.py:32-118) ---------------

def qt_spatial(fn, x):
    """A quantization-transparent op (slice, concat, shuffle, layout view)
    on a float tensor or on a QTensor's values."""
    if isinstance(x, Q.QTensor):
        return Q.QTensor(fn(x.values), x.scale, x.zero_point)
    return fn(x)


def qt_concat(xs, dim):
    """Concat of float tensors or of QTensors that share one scale (the
    stage's shared quantizer makes them so at every merge)."""
    if isinstance(xs[0], Q.QTensor):
        return Q.QTensor(torch.cat([x.values for x in xs], dim),
                         xs[0].scale, xs[0].zero_point)
    return torch.cat(xs, dim)


def qt_module(module, x):
    """A float module that only moves values (max pool, nearest upsample)
    on a float tensor, or on a QTensor's int8 values through f32: exact,
    and where the pool pads, each window holds one element of the map, so
    its -inf padding acts as the JAX int8 pool's iinfo.min."""
    if isinstance(x, Q.QTensor):
        return qt_spatial(lambda v: module(v.float()).to(v.dtype), x)
    return module(x)


def as_float(x):
    return x.dequant() if isinstance(x, Q.QTensor) else x


def set_deploy(mod, q_w, w_scale, bias):
    """Give `mod` (a conv or the deform weight holder) fixed integer
    weights: int8 OIHW levels, (O,) scales and the f32 bias (None for
    none), as non-persistent buffers that follow the module's device and
    stay out of its state_dict."""
    for name, value in (("q_w", q_w), ("w_scale", w_scale),
                        ("bias", bias)):
        mod.register_buffer("deploy_" + name, value, persistent=False)


@contextlib.contextmanager
def capturing_deploy(model):
    """Within the block, every int8 conv of `model` that derives its
    integer weights also records them in the yielded dict, keyed by its
    module: {"q_w", "w_scale", "bias", "w_bit"} (the JAX package's
    'deploy' collection made mutable for one apply). Nothing is recorded
    outside it, so building or loading a model never captures."""
    sink = {}
    mods = list(model.modules())
    for m in mods:
        m.deploy_sink = sink
    try:
        yield sink
    finally:
        for m in mods:
            del m.deploy_sink


def resolve_int8_weights(mod, float_weights, w_bit, qspec):
    """(q_w, w_scale, bias) of `mod`'s int8 conv, in the three modes of the
    JAX package's resolve_int8_weights: inside `capturing_deploy`, derived
    from the float weights and recorded; with fixed weights set
    (`set_deploy`), those; else derived. `float_weights()` returns the
    (folded) float (weight, bias) and is called only to derive."""
    sink = getattr(mod, "deploy_sink", None)
    if sink is None and getattr(mod, "deploy_q_w", None) is not None:
        return mod.deploy_q_w, mod.deploy_w_scale, mod.deploy_bias
    weight, bias = float_weights()
    q_w, w_scale = Q.quantize_weight_int(weight, w_bit, qspec.wt_percentile)
    if sink is not None:
        sink[mod] = {"q_w": q_w, "w_scale": w_scale, "bias": bias,
                     "w_bit": w_bit}
    return q_w, w_scale, bias


def resolve_fakequant_weight(mod, weight, w_bit, qspec):
    """The deform kernel's quantized float weight in int8 mode, q / scale
    from `resolve_int8_weights` (so the artifact carries it as levels and
    scales, and checkpoint and artifact evals sample with the same
    bits)."""
    q_w, w_scale, _ = resolve_int8_weights(mod, lambda: (weight, None),
                                           w_bit, qspec)
    return q_w.float() / w_scale[:, None, None, None]


def _int8_conv(conv_mod, x, float_weights, qspec, w_bit):
    q_w, w_scale, bias = resolve_int8_weights(
        conv_mod, float_weights, w_bit or qspec.w_bit, qspec)
    return Q.int8_conv(x, q_w, w_scale, bias, conv_mod.stride,
                       conv_mod.padding, conv_mod.groups)


def conv2d(x, weight, bias, dtype, stride=1, padding=0, dilation=1,
           groups=1):
    """The convolution of x with `weight` and `bias` (or None). dtype
    None: in x's type, the bias fused. A compute dtype: the conv of x and
    weight rounded to it, in f32 (on a card cuDNN runs it on TF32 tensor
    cores where TF32 is allowed: bf16 operands are exact in TF32); with a
    bias, that result rounded to it and the rounded bias added in f32 (the
    JAX conv2d and Conv, layers.py:176-188, 430-435, as XLA compiles
    them)."""
    if dtype is None:
        return F.conv2d(x, weight, bias, stride, padding, dilation, groups)
    y = F.conv2d(x.to(dtype).float(), weight.to(dtype).float(), None,
                 stride, padding, dilation, groups)
    if bias is None:
        return y
    return (y.to(dtype).float()
            + bias.to(dtype).float()[None, :, None, None])


def _conv(conv_mod, x, weight, bias, dtype):
    """`conv_mod`'s convolution of x with `weight` and `bias` (`conv2d`);
    inside `row_sharded`, of this rank's band, widened by its halo
    (`halo_rows`) where the window reads other rows."""
    padding = conv_mod.padding
    sp = _ROWS.get()
    k, stride = conv_mod.kernel_size[0], conv_mod.stride[0]
    if sp is not None and (k > 1 or stride > 1):
        x = halo_rows(x, sp, k, stride, padding[0], conv_mod.dilation[0])
        padding = (0, padding[1])
    return conv2d(x, weight, bias, dtype, conv_mod.stride, padding,
                  conv_mod.dilation, conv_mod.groups)


def conv_q(conv_mod, x, qspec, w_bit=None, dtype=None):
    """Conv with the weight fake-quantized in quant mode; the bias stays
    full precision (reference Quant_Conv2d, quant_modules.py:228-321). A
    QTensor input runs the int8 conv (the JAX ``Conv``'s int8 branch).
    `dtype`: the operands' compute dtype (`_conv`)."""
    if qspec is None:
        return _conv(conv_mod, x, conv_mod.weight, conv_mod.bias, dtype)
    if isinstance(x, Q.QTensor):
        return _int8_conv(conv_mod, x,
                          lambda: (conv_mod.weight, conv_mod.bias), qspec,
                          w_bit)
    return _conv(conv_mod, x, fake_quant(conv_mod.weight, qspec, w_bit),
                 conv_mod.bias, dtype)


def conv_bn(conv_mod, bn_mod, x, qspec, w_bit=None, dtype=None):
    """Conv + BN. FP32: the two modules (BN in its train/eval mode, on the
    f32 conv result whatever the operands' `dtype`). Quant: BN folded from
    its running statistics, the folded weight fake-quantized, one conv
    (reference QuantBnConv2d, quant_modules.py:324-419): QAT trains
    against frozen folded BN. A QTensor input runs the folded conv in
    int8 (the JAX ``ConvBN``'s int8 branch)."""
    if qspec is None:
        return bn_mod(_conv(conv_mod, x, conv_mod.weight, None, dtype))

    def folded():
        return Q.fold_bn(conv_mod.weight, None, bn_mod.weight, bn_mod.bias,
                         bn_mod.running_mean, bn_mod.running_var,
                         bn_mod.eps)
    if isinstance(x, Q.QTensor):
        return _int8_conv(conv_mod, x, folded, qspec, w_bit)
    w, b = folded()
    return _conv(conv_mod, x, fake_quant(w, qspec, w_bit), b, dtype)


class DeformWeight(nn.Module):
    """Holder of the depthwise deform kernel, OIHW (C, 1, 3, 3), named like
    the reference's DeformConv submodule (``...conv.weight``)."""

    def __init__(self, channels):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(channels, 1, 3, 3))


class CodesignDeformBlock(nn.Module):
    """DeformConvWithOffsetScaleBoundPositive (reference
    modules/dcn_deform_conv.py:285-330):

      s = Hardtanh[-bound+1, bound](conv_scale(x))
      y = depthwise co-designed deform conv of x with s
      y = BN(conv_channel(y)) if in != out else BN(y)

    The BatchNorm is the caller's module (reference
    ``deconv_layers.{4i+1}``), passed in as `bn`. The JAX package's
    ``CodesignDeformBlock`` is this block with that BN. Stride 1 runs
    ``codesign_deform_conv_fast`` (the CUDA kernels on a card, forward and
    backward); stride 2 the plain ``codesign_deform_conv``, as in the JAX
    package (layers.py:559-576).

    Quant (reference QuantDeformConvWithOffsetScaleBoundPositive,
    quant_modules.py:621-671): conv_scale's weight fake-quantized, s
    through `scale_act`, the deform weight fake-quantized, `deform_act`
    between the deform conv and the mixer, and the mixer + BN folded.
    Int8 (the JAX block's int8 path, layers.py:554-574): conv_scale an
    int8 conv, s dequantized, x dequantized and sampled in bf16 with the
    quantized weight in bf16 (the bf16 kernel on a card), and `deform_act`
    hands the mixer a QTensor.

    bf16 (`dtype`, layers.py:511-591): conv_scale takes bf16 operands
    (its f32 result is s); the fast path samples x with the weight both
    rounded to bf16 (the bf16 kernels on a card, forward and backward),
    and its bf16 output is widened to x's type; stride 2 samples in x's
    type (f32), as the JAX block does.
    """

    def __init__(self, in_channels, features, stride=1, offset_bound=8,
                 qspec=None, dtype=None):
        super().__init__()
        self.qspec = qspec
        self.dtype = dtype
        self.stride = stride
        self.offset_bound = offset_bound
        self.conv_scale = conv(in_channels, 1, 1, stride, 0, bias=True)
        self.conv = DeformWeight(in_channels)
        self.conv_channel = (conv(in_channels, features)
                             if in_channels != features else None)
        self.scale_act = quant_act(qspec)
        self.deform_act = quant_act(qspec)

    @torch.no_grad()
    def reset_parameters(self, generator):
        # scale predictor: weight zero, bias one (dcn_deform_conv.py:295-302)
        self.conv_scale.weight.zero_()
        self.conv_scale.bias.fill_(1.0)
        deform_weight_init_(self.conv.weight, self.conv.weight.shape[0],
                            generator)
        if self.conv_channel is not None:
            kaiming_normal_relu_(self.conv_channel.weight, generator)

    def forward(self, x, bn, update=False):
        q = self.qspec
        int8 = q is not None and q.int8_infer
        s = F.hardtanh(conv_q(self.conv_scale, x, q, dtype=self.dtype),
                       -self.offset_bound + 1, self.offset_bound)
        s = as_float(apply_act(self.scale_act, s, update))
        x = as_float(x)
        x_nhwc = nhwc(x.contiguous(memory_format=torch.channels_last))
        s_nhwc = nhwc(s).contiguous()
        if q is None:
            weight = self.conv.weight
        elif int8:
            weight = resolve_fakequant_weight(self.conv, self.conv.weight,
                                              q.w_bit, q)
        else:
            weight = fake_quant(self.conv.weight, q)
        w_hwio = weight.permute(2, 3, 1, 0)
        if self.stride == 1:
            kdtype = INT8_SAMPLE_DTYPE if int8 else self.dtype
            if kdtype is not None:
                x_nhwc = x_nhwc.to(kdtype)
                w_hwio = w_hwio.to(kdtype)
            y = codesign_deform_conv_fast(x_nhwc, s_nhwc, w_hwio).to(
                x.dtype)
        else:
            y = codesign_deform_conv(x_nhwc, s_nhwc, w_hwio,
                                     stride=self.stride)
        y = apply_act(self.deform_act, nchw(y), update)
        if self.conv_channel is not None:
            return conv_bn(self.conv_channel, bn, y, q, dtype=self.dtype)
        if q is None:
            return bn(y)
        # quant mode without a mixer: BN from running stats, unfolded (the
        # JAX BatchNorm with train=False)
        return F.batch_norm(as_float(y), bn.running_mean, bn.running_var,
                            bn.weight, bn.bias, False, 0.0, bn.eps)
