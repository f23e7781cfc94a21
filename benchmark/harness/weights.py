"""The seeded FP32 state that both the program and the reference start
from, made on the device.

Every weight is drawn in one `torch.randn` call on the device from the
seed and scaled per tensor: convolutions He-normal over their fan-in, the
deform kernels CoDeNet's U(+-1/sqrt(9 C)) spread, the deform blocks'
scale predictors small (so s = 1 + a few tenths: fractional sampling
positions), the heatmap's last conv torch's default spread with bias
-2.19. BN scales are 1 and BN shifts +3 (but the heads' last BNs, 0): at
zero shifts a random network this deep with train-mode BN is chaotic in
float32, and two correct devices disagree as much as float32 does from
float64 (the program's own tools measured 5% against 8e-5 of gradient
L2). The BN running statistics are then those of one batch of the
cell's frames through the reference in train mode, as a trained model's
would be, so the eval-mode and folded forwards are as well-conditioned as
the training ones."""

from __future__ import annotations

import math

import numpy as np
import torch

from ..reference import geometry
from ..reference.model import Net, calibrate, state_shapes

BN_SHIFT = 3.0
SCALE_SPREAD = 0.2


def _std(name, shape, fan_in):
    if name.endswith("conv_scale.weight"):
        return SCALE_SPREAD / math.sqrt(fan_in)
    if name.endswith("conv.weight"):  # the deform kernel
        return 1.0 / math.sqrt(3 * 9 * shape[0])
    if name.startswith("hm.") and name.endswith(".6.weight"):
        return 1.0 / math.sqrt(3 * fan_in)
    return math.sqrt(2.0 / fan_in)


def make(cfg, seed, device, quant=False):
    """(params, buffers): dicts of f32 tensors on `device` named as the
    state_dict names them (no BN calibration yet)."""
    shapes = state_shapes(cfg["heads"], cfg["w2"], cfg["head_conv"], quant)
    convs = {k: s for k, s in shapes.items() if len(s) == 4}
    total = sum(int(np.prod(s)) for s in convs.values())
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    flat = torch.randn(total, generator=gen, device=device)
    params, buffers, at = {}, {}, 0
    for name, shape in convs.items():
        n = int(np.prod(shape))
        fan_in = int(np.prod(shape[1:]))
        params[name] = flat[at:at + n].view(shape) * _std(name, shape,
                                                          fan_in)
        at += n
    heads_last_bn = {h + ".4" for h in cfg["heads"]}
    for name, shape in shapes.items():
        if name in params:
            continue
        base, leaf = name.rsplit(".", 1)
        if leaf == "weight":
            params[name] = torch.ones(shape, device=device)
        elif leaf == "bias" and base.endswith("conv_scale"):
            params[name] = torch.ones(shape, device=device)
        elif leaf == "bias" and base.endswith(".6"):
            params[name] = torch.full(shape, -2.19 if base == "hm.6" else
                                      0.0, device=device)
        elif leaf == "bias":
            params[name] = torch.full(
                shape, 0.0 if base in heads_last_bn else BN_SHIFT,
                device=device)
        elif leaf == "running_var":
            buffers[name] = torch.ones(shape, device=device)
        elif leaf == "num_batches_tracked":
            buffers[name] = torch.zeros(shape, dtype=torch.long,
                                        device=device)
        else:  # running_mean, x_min, x_max
            buffers[name] = torch.zeros(shape, device=device)
    return params, buffers


def calibrated(cfg, params, buffers, frames_u8, dims, quant=None):
    """`buffers` with the BN statistics of `frames_u8` (N, H, W, 3) uint8
    frames of extents `dims`, letterboxed to the input and normalised,
    through the reference's FP32 network in train mode; with `quant`,
    also the activation quantizers' ranges of those frames through the
    quantized network (a fine-tune's steady state, where each step's EMA
    moves a range by a hundredth of the batch's, not to it)."""
    ih, iw = cfg["input_hw"]
    warp_ti = np.stack([geometry.letterbox(int(h), int(w), (ih, iw))[0]
                        for h, w in dims])
    x = geometry.warp(frames_u8, warp_ti, ih, iw, extents=dims) / 255.0
    mean = torch.as_tensor(np.asarray(cfg["mean"], np.float32),
                           device=x.device)
    std = torch.as_tensor(np.asarray(cfg["std"], np.float32),
                          device=x.device)
    x = ((x - mean) / std).permute(0, 3, 1, 2).contiguous()
    net = Net(cfg["heads"], cfg["w2"], cfg["head_conv"])
    out = calibrate(net, x, params, buffers)
    if quant:
        with torch.no_grad():
            Net(cfg["heads"], cfg["w2"], cfg["head_conv"], quant).forward(
                x, params, out, update=True)
    return out


def state_dict(params, buffers):
    return {**params, **buffers}
