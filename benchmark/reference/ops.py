"""The network's operations, plain: the co-designed depthwise deform conv
as gathers (CoDeNet's DeformConvWithOffsetScaleBoundPositive sampling,
tap t at p + a_t * s, s clamped to [-7, 8], each bilinear corner zeroed
outside the map), W4A8 fake-quant (symmetric per-channel weights,
asymmetric EMA-ranged activations, straight-through gradients, the
reference quantizer's rounding), BN folding, and convolutions in the
reference's precision."""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

ANCHORS = ((-1, -1), (-1, 0), (-1, 1), (0, -1), (0, 0), (0, 1),
           (1, -1), (1, 0), (1, 1))
S_LO, S_HI = -7.0, 8.0


def tf32_round(x):
    """x rounded to TF32 (10 explicit mantissa bits, nearest, ties away);
    the gradient passes unchanged, as through the card's TF32 operands."""
    with torch.no_grad():
        bits = x.detach().float().contiguous().view(torch.int32)
        rounded = ((bits + 0x1000) & ~0x1FFF).view(torch.float32)
    return x + (rounded - x).detach()


def conv(x, weight, bias=None, stride=1, padding=0, groups=1,
         precision="f32"):
    """F.conv2d in f32; "tf32" rounds both operands to TF32 first."""
    if precision == "tf32":
        x, weight = tf32_round(x), tf32_round(weight)
    return F.conv2d(x, weight, bias, stride, padding, 1, groups)


def deform(x, s, weight):
    """Co-designed depthwise 3x3 deform conv, stride 1, padding 1.
    x (N, C, H, W), s (N, 1, H, W), weight (C, 1, 3, 3); autograd through
    the gathers gives its gradient."""
    n, c, h, w = x.shape
    xf = x.permute(0, 2, 3, 1).reshape(n, h * w, c)
    sf = s.reshape(n, h * w).clamp(S_LO, S_HI)
    p = torch.arange(h * w, device=x.device)
    py, px = (p // w).float(), (p % w).float()
    wt = weight.reshape(c, 9).t()
    out = 0.0
    for t, (ai, aj) in enumerate(ANCHORS):
        sy, sx = py + ai * sf, px + aj * sf
        y0, x0 = torch.floor(sy), torch.floor(sx)
        fy, fx = sy - y0, sx - x0
        y0, x0 = y0.long(), x0.long()
        tap = 0.0
        for dy, dx in ((0, 0), (0, 1), (1, 0), (1, 1)):
            yy, xx = y0 + dy, x0 + dx
            ok = (yy >= 0) & (yy < h) & (xx >= 0) & (xx < w)
            idx = yy.clamp(0, h - 1) * w + xx.clamp(0, w - 1)
            wgt = (fy if dy else 1 - fy) * (fx if dx else 1 - fx) * ok
            g = torch.gather(xf, 1, idx[..., None].expand(-1, -1, c))
            tap = tap + g * wgt[..., None]
        out = out + tap * wt[t]
    return out.reshape(n, h, w, c).permute(0, 3, 1, 2)


def _ste(x, q):
    with torch.no_grad():
        d = q(x) - x
    return x + d


def _over(n, t):
    return torch.full((), float(n), dtype=t.dtype, device=t.device) / t


def fake_quant_weight(w, bits, percentile):
    """Symmetric per-output-channel fake-quant of an OIHW weight; with
    `percentile`, the channel's 0.1 / 99.9 percentile range (ceil-indexed
    k-th values; under 10 elements, 0.95 of min / max)."""
    o = w.shape[0]
    flat = w.detach().reshape(o, -1)
    length = flat.shape[1]
    if not percentile:
        lo, hi = flat.amin(1), flat.amax(1)
    elif length < 10:
        lo, hi = flat.amin(1) * 0.95, flat.amax(1) * 0.95
    else:
        s = torch.sort(flat, dim=1).values
        lo_i = max(int(math.ceil(length * 0.1 * 0.01)), 1)
        hi_i = min(max(int(math.ceil(length * 99.9 * 0.01)), 1), length)
        lo, hi = s[:, lo_i - 1], s[:, hi_i - 1]
    mag = torch.maximum(lo.abs(), hi.abs())[:, None, None, None]
    n = 2 ** (bits - 1) - 1

    def q(v):
        scale = _over(n, torch.clamp(mag, min=1e-10))
        r = torch.clamp(torch.round(scale * v), -(2 ** (bits - 1)),
                        2 ** (bits - 1) - 1)
        return r / scale
    return _ste(w, q)


def fake_quant_act(x, bits, x_min, x_max, clamp):
    """Asymmetric fake-quant with an integral, signed-shifted zero point;
    clamp=True clamps to the signed int8 window."""
    n = 2 ** bits - 1

    def q(v):
        scale = _over(n, torch.clamp(x_max - x_min, min=1e-10))
        zp = torch.round(scale * x_min) + 2 ** (bits - 1)
        r = torch.round(scale * v - zp)
        if clamp:
            r = torch.clamp(r, -(2 ** (bits - 1)), 2 ** (bits - 1) - 1)
        return (r + zp) / scale
    return _ste(x, q)


@torch.no_grad()
def ema_range(x_min, x_max, x, momentum=0.99):
    """The activation range EMA, the first batch taking its own range."""
    bmin, bmax = x.min(), x.max()
    init = x_min == x_max
    return (torch.where(init, x_min + bmin,
                        momentum * x_min + (1 - momentum) * bmin),
            torch.where(init, x_max + bmax,
                        momentum * x_max + (1 - momentum) * bmax))


def fold_bn(w, gamma, beta, mean, var, eps=1e-5):
    """Conv weight and bias with a frozen BN folded in."""
    factor = gamma / torch.sqrt(var + eps)
    return w * factor[:, None, None, None], (-mean) * factor + beta


def channel_shuffle(x, groups=2):
    """ShuffleNet's channel shuffle of (N, C, H, W)."""
    n, c, h, w = x.shape
    return x.reshape(n, groups, c // groups, h, w).transpose(1, 2).reshape(
        n, c, h, w)
