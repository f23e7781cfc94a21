"""The seeded FP32 state that both the program and the reference start
from, made on the device.

The configuration's architecture module (`reference/arch/`) names the
tensors and sets each one's init: every 4-D weight is drawn in one
`torch.randn` call on the device from the seed, in the module's order,
and scaled by its std; every other tensor is the module's constant. The
BN running statistics are then those of one batch of the cell's frames
through the reference in train mode, as a trained model's would be, so
the eval-mode and folded forwards are as well-conditioned as the
training ones."""

from __future__ import annotations

import numpy as np
import torch

from ..reference import geometry, ops

# state the program keeps as buffers: BN statistics, quantizer ranges
BUFFERS = ("running_mean", "running_var", "num_batches_tracked", "x_min",
           "x_max")


def make(arch, cfg, seed, device, quant=False):
    """(params, buffers): dicts of f32 tensors on `device` named as the
    state_dict names them (no BN calibration yet), of the configuration
    `cfg` of architecture module `arch`."""
    shapes = arch.state_shapes(cfg, quant)
    convs = {k: s for k, s in shapes.items() if len(s) == 4}
    total = sum(int(np.prod(s)) for s in convs.values())
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    flat = torch.randn(total, generator=gen, device=device)
    params, buffers, at = {}, {}, 0
    for name, shape in convs.items():
        n = int(np.prod(shape))
        params[name] = flat[at:at + n].view(shape) * arch.init(cfg, name,
                                                               shape)
        at += n
    for name, shape in shapes.items():
        if name in params:
            continue
        leaf = name.rsplit(".", 1)[1]
        value = arch.init(cfg, name, shape)
        if leaf == "num_batches_tracked":
            buffers[name] = torch.full(shape, int(value), dtype=torch.long,
                                       device=device)
        elif leaf in BUFFERS:
            buffers[name] = torch.full(shape, float(value), device=device)
        else:
            params[name] = torch.full(shape, float(value), device=device)
    return params, buffers


def calibrated(arch, cfg, params, buffers, frames_u8, dims, quant=None):
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
    out = ops.calibrate(arch.Net(cfg), x, params, buffers)
    if quant:
        with torch.no_grad():
            arch.Net(cfg, quant).forward(x, params, out, update=True)
    return out


def state_dict(params, buffers):
    return {**params, **buffers}
