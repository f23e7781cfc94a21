"""InPlace-ABN: activated batch-norm that keeps only its output for the
backward (the JAX package's ops/abn.py; reference lib/models/external/
src/inplace_abn.cpp:86-94, inplace_abn_cpu.cpp:45-84). The reference
builds the op but no model of it calls it; it completes the op
inventory.

Standard BN + activation keeps the input x (or x-hat) alive for the
backward. InPlace-ABN saves the activation's output and rebuilds the
rest by inverting the (invertible) activation and the affine transform.
Here `inplace_abn` is a `torch.autograd.Function` that saves (out, var,
weight, bias) and never x, so x may be freed after the forward.

Semantics of the reference C++, as the JAX package keeps them:

- the scale is |weight| + eps (inplace_abn_cpu.cpp:37-43, 56);
- backward: y = (z - bias) / (|weight| + eps); edz = sum(dz);
  eydz = sum(y * dz); dx = (dz - edz / num - y * eydz / num) *
  rsqrt(var + eps) * (|weight| + eps) (backward_cpu:76-85), the
  train-mode BN backward in terms of the output; with frozen statistics
  dx = dz * rsqrt(var + eps) * (|weight| + eps);
- dweight = eydz * sign(weight), dbias = edz;
- activations: leaky_relu (slope), elu and identity.

Tensors are channels-last, (..., C), as in the JAX package.
"""

from __future__ import annotations

import torch
from torch import nn


def _act(z, activation, slope):
    if activation == "leaky_relu":
        return torch.where(z >= 0, z, slope * z)
    if activation == "elu":
        return torch.where(z >= 0, z, torch.expm1(z))
    return z


def _inv_act(out, activation, slope):
    """The pre-activation z rebuilt from the output."""
    if activation == "leaky_relu":
        return torch.where(out >= 0, out, out / slope)
    if activation == "elu":
        return torch.where(out >= 0, out, torch.log1p(out))
    return out


def _dact_from_out(out, activation, slope):
    """activation'(z) from the output's sign (elu: exp(z) = out + 1)."""
    if activation == "leaky_relu":
        return torch.where(out >= 0, 1.0, slope).to(out.dtype)
    if activation == "elu":
        return torch.where(out >= 0, 1.0, out + 1.0)
    return torch.ones_like(out)


class _InPlaceABN(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, weight, bias, mean, var, eps, activation, slope,
                training):
        out = abn_reference(x, weight, bias, mean, var, eps, activation,
                            slope)
        ctx.save_for_backward(out, weight, bias, var)
        ctx.cfg = (eps, activation, slope, training)
        return out

    @staticmethod
    def backward(ctx, dout):
        out, weight, bias, var = ctx.saved_tensors
        eps, activation, slope, training = ctx.cfg
        gamma = weight.abs() + eps
        z = _inv_act(out, activation, slope)
        dz = dout * _dact_from_out(out, activation, slope)
        y = (z - bias) / gamma
        red = tuple(range(out.dim() - 1))
        num = out.numel() // out.shape[-1]
        edz = dz.sum(dim=red)
        eydz = (y * dz).sum(dim=red)
        mul = torch.rsqrt(var + eps) * gamma
        if training:
            dx = (dz - edz / num - y * eydz / num) * mul
        else:
            dx = dz * mul
        # mean and var take no gradient (folded into dx)
        return (dx, eydz * torch.sign(weight), edz, None, None, None, None,
                None, None)


def inplace_abn(x, weight, bias, mean, var, eps=1e-5,
                activation="leaky_relu", slope=0.01, training=True):
    """act((x - mean) * rsqrt(var + eps) * (|weight| + eps) + bias).

    x: (..., C); weight, bias, mean, var: (C,). mean and var take no
    gradient. training=True: they are x's batch statistics, and dx is the
    through-statistics BN backward; training=False: frozen statistics,
    dx = dz * mul."""
    return _InPlaceABN.apply(x, weight, bias, mean, var, eps, activation,
                             slope, training)


def abn_reference(x, weight, bias, mean, var, eps=1e-5,
                  activation="leaky_relu", slope=0.01):
    """The same function in plain autograd (keeps x alive): the oracle."""
    gamma = weight.abs() + eps
    z = (x - mean) * torch.rsqrt(var + eps) * gamma + bias
    return _act(z, activation, slope)


class InPlaceABN(nn.Module):
    """Batch statistics in training (the running statistics move by
    `momentum`, with the biased variance, as in the JAX package), the
    running statistics at eval (inplace_abn_cpu.cpp:45-64)."""

    def __init__(self, num_features, eps=1e-5, momentum=0.1,
                 activation="leaky_relu", slope=0.01):
        super().__init__()
        self.eps = eps
        self.momentum = momentum
        self.activation = activation
        self.slope = slope
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))

    def forward(self, x):
        if self.training:
            with torch.no_grad():
                red = tuple(range(x.dim() - 1))
                mean = x.mean(dim=red)
                var = ((x - mean) ** 2).mean(dim=red)
                m = self.momentum
                self.running_mean.mul_(1 - m).add_(m * mean)
                self.running_var.mul_(1 - m).add_(m * var)
        else:
            mean, var = self.running_mean, self.running_var
        return inplace_abn(x, self.weight, self.bias, mean, var, self.eps,
                           self.activation, self.slope, self.training)
