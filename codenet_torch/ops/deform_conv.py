"""Deformable convolution in plain PyTorch (NHWC, HWIO), plus a numpy oracle.

`deform_sample` gathers, for every output position and kernel tap, a
bilinear blend of 4 neighbours of the input; a tap-weight contraction
(einsum) then replaces the reference's im2col GEMM
(lib/models/external/src/dcn_deform_conv_cuda_kernel.cu:190-242).
Boundary semantics match the reference CUDA bilinear (kernel.cu:97-109):
a sampling position contributes 0 outside (-1, H) x (-1, W), and each of
the four corners is zeroed separately inside.

The co-designed CoDeNet variant (reference modules/dcn_deform_conv.py:
285-330) constrains every tap offset to `anchor * (s - 1)` for one scalar
s per position, so tap (i, j) samples `p + (i, j) * s` at dilation 1.
`codesign_deform_conv` is that op at any stride; its stride-1 depthwise
form has a CUDA kernel in `deform_cuda.py`. `deform_conv2d` is the
general op (groups, deformable groups, the DCNv2 mask) of the resdcn and
dla networks; in the JAX package it is XLA code, not a Pallas kernel, and
here it is plain PyTorch on the same two pieces.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import device_constant
from ..utils.profile import counted_op

# Per-tap (dy, dx) anchors of a 3x3 kernel, row-major — the reference's
# anchor_offset constant (modules/dcn_deform_conv.py:319-321) as (9, 2).
ANCHOR_OFFSETS = np.array(
    [[-1, -1], [-1, 0], [-1, 1],
     [0, -1], [0, 0], [0, 1],
     [1, -1], [1, 0], [1, 1]], dtype=np.float32)


def _pair(v):
    return tuple(v) if isinstance(v, (tuple, list)) else (v, v)


def _conv_out_size(size, k, stride, pad, dil):
    return (size + 2 * pad - (dil * (k - 1) + 1)) // stride + 1


def deform_sample(x, tap_offsets, kernel_size=(3, 3), stride=1, padding=1,
                  dilation=1):
    """Bilinear-sample deformable im2col columns.

    x: (N, H, W, C); tap_offsets: (N, Ho, Wo, K, 2) per-tap (dy, dx)
    offsets added to the standard convolution sampling positions
    (K = kh*kw). Returns (N, Ho, Wo, K, C), zero outside the input.
    """
    kh, kw = _pair(kernel_size)
    sh, sw = _pair(stride)
    ph, pw = _pair(padding)
    dh, dw = _pair(dilation)

    n, h, w, c = x.shape
    ho = _conv_out_size(h, kh, sh, ph, dh)
    wo = _conv_out_size(w, kw, sw, pw, dw)
    k = kh * kw
    if tuple(tap_offsets.shape[1:]) != (ho, wo, k, 2):
        raise ValueError("tap_offsets {} vs expected {}".format(
            tuple(tap_offsets.shape), (ho, wo, k, 2)))

    dev = x.device
    ys = torch.arange(ho, dtype=torch.float32, device=dev) * sh - ph
    xs = torch.arange(wo, dtype=torch.float32, device=dev) * sw - pw
    ti = torch.arange(kh, dtype=torch.float32, device=dev) * dh
    tj = torch.arange(kw, dtype=torch.float32, device=dev) * dw
    base_y = ys[:, None, None] + ti.repeat_interleave(kw)[None, None, :]
    base_x = xs[None, :, None] + tj.repeat(kh)[None, None, :]

    sy = base_y[None] + tap_offsets[..., 0]  # (N, Ho, Wo, K)
    sx = base_x[None] + tap_offsets[..., 1]
    y0 = torch.floor(sy)
    x0 = torch.floor(sx)
    fy = (sy - y0).to(x.dtype)
    fx = (sx - x0).to(x.dtype)
    y0i = y0.long()
    x0i = x0.long()

    x_flat = x.reshape(n, h * w, c)

    def corner(yi, xi, wgt):
        valid = (yi >= 0) & (yi < h) & (xi >= 0) & (xi < w)
        idx = yi.clamp(0, h - 1) * w + xi.clamp(0, w - 1)
        g = torch.gather(x_flat, 1,
                         idx.reshape(n, -1, 1).expand(-1, -1, c))
        g = g.reshape(n, ho, wo, k, c)
        return g * (wgt * valid.to(x.dtype))[..., None]

    out = corner(y0i, x0i, (1 - fy) * (1 - fx))
    out = out + corner(y0i, x0i + 1, (1 - fy) * fx)
    out = out + corner(y0i + 1, x0i, fy * (1 - fx))
    out = out + corner(y0i + 1, x0i + 1, fy * fx)
    return out


def _contract(cols, weight, groups):
    """Tap-weight contraction. cols: (N, Ho, Wo, K, C); weight: HWIO
    (kh, kw, Cin/groups, Cout)."""
    kh, kw, cpg, cout = weight.shape
    k = kh * kw
    n, ho, wo, _, c = cols.shape
    wf = weight.reshape(k, cpg, cout)
    if groups == 1:
        return torch.einsum("nhwkc,kco->nhwo", cols, wf)
    if cpg == 1 and cout == c and groups == c:  # depthwise
        return torch.einsum("nhwkc,kc->nhwc", cols, wf.reshape(k, cout))
    opg = cout // groups
    colsg = cols.reshape(n, ho, wo, k, groups, cpg)
    # torch groups order out channels consecutively per group
    wg = wf.reshape(k, cpg, groups, opg)
    out = torch.einsum("nhwkgc,kcgo->nhwgo", colsg, wg)
    return out.reshape(n, ho, wo, cout)


def deform_conv_flops(out_shape, weight_shape, masked_channels=0):
    """FLOPs of a deform conv as `utils.profile.count_flops` counts it:
    two a multiply-add of the tap-weight contraction (taps x channels of
    a group x output positions x Cout x 2, what FlopCounterMode counts
    for a conv of the same shape), plus one for each sample the DCNv2
    mask scales (taps x output positions x `masked_channels`, the input
    channels). The bilinear sampling counts nothing, as no elementwise op
    does.

    out_shape: (N, Ho, Wo, Cout); weight_shape: HWIO (kh, kw, Cin/groups,
    Cout)."""
    n, ho, wo, cout = out_shape
    kh, kw, cpg, _ = weight_shape
    return n * ho * wo * kh * kw * (2 * cpg * cout + masked_channels)


def deform_conv2d(x, offset, weight, stride=1, padding=1, dilation=1,
                  groups=1, deformable_groups=1, mask=None):
    """General deformable convolution (DCNv1, and DCNv2 with `mask`), the
    JAX package's ops/deform_conv.py:138-172; autograd differentiates it.

    x: (N, H, W, C); offset: (N, Ho, Wo, dg*2*K) in the reference channel
    layout [tap0_dy, tap0_dx, tap1_dy, ...] per deformable group; weight:
    HWIO (kh, kw, C//groups, Cout); mask: None or (N, Ho, Wo, dg*K), which
    multiplies each group's sampled columns. Returns (N, Ho, Wo, Cout).
    """
    kh, kw = weight.shape[0], weight.shape[1]
    k = kh * kw
    n, ho, wo, oc = offset.shape
    dg = deformable_groups
    if oc != dg * 2 * k:
        raise ValueError("offset channels {} != {}".format(oc, dg * 2 * k))
    flops = deform_conv_flops((n, ho, wo, weight.shape[3]), weight.shape,
                              0 if mask is None else x.shape[-1])
    with counted_op(flops):
        offs = offset.reshape(n, ho, wo, dg, k, 2)
        cpdg = x.shape[-1] // dg
        cols = []
        for g in range(dg):
            xg = x[..., g * cpdg:(g + 1) * cpdg] if dg > 1 else x
            col = deform_sample(xg, offs[:, :, :, g], (kh, kw), stride,
                                padding, dilation)
            if mask is not None:
                col = col * mask.reshape(n, ho, wo, dg, k)[:, :, :, g, :,
                                                           None]
            cols.append(col)
        cols = cols[0] if dg == 1 else torch.cat(cols, dim=-1)
        return _contract(cols, weight.to(cols.dtype), groups)


def codesign_deform_conv(x, s, weight, stride=1, padding=1, dilation=1,
                         groups=None):
    """CoDeNet's co-designed deformable conv: one scale per position.

    Tap (i, j) of the 3x3 kernel samples at `p + (i, j) * dilation +
    anchor_(i,j) * (s - 1)` (reference modules/dcn_deform_conv.py:323-330).

    x: (N, H, W, C); s: (N, Ho, Wo, 1); weight: HWIO (3, 3, C//groups,
    Cout), depthwise (3, 3, 1, C) by default (groups = C).
    """
    c = x.shape[-1]
    if groups is None:
        groups = c
    with counted_op(deform_conv_flops(s.shape[:3] + (weight.shape[3],),
                                      weight.shape)):
        anchor = device_constant(ANCHOR_OFFSETS, x.device)  # (9, 2)
        tap_offsets = anchor[None, None, None] * (s[..., None] - 1.0)
        cols = deform_sample(x, tap_offsets, (3, 3), stride, padding,
                             dilation)
        return _contract(cols, weight.to(cols.dtype), groups)


def deform_conv2d_naive(x, offset, weight, stride=1, padding=1, dilation=1,
                        groups=1, deformable_groups=1):
    """O(N*Ho*Wo*K*C) python-loop reference for correctness tests.

    x: (N, H, W, C); offset: (N, Ho, Wo, dg*2*K) in the reference channel
    layout [tap0_dy, tap0_dx, tap1_dy, ...]; weight: HWIO.
    """
    x = np.asarray(x, dtype=np.float64)
    offset = np.asarray(offset, dtype=np.float64)
    weight = np.asarray(weight, dtype=np.float64)
    kh, kw, cpg, cout = weight.shape
    n, h, w, c = x.shape
    ho = _conv_out_size(h, kh, stride, padding, dilation)
    wo = _conv_out_size(w, kw, stride, padding, dilation)
    k = kh * kw
    dg = deformable_groups
    cpdg = c // dg
    opg = cout // groups
    cin_pg = c // groups
    out = np.zeros((n, ho, wo, cout))

    def bilin(img2d, sy, sx):
        if sy <= -1 or sy >= h or sx <= -1 or sx >= w:
            return 0.0
        y0, x0 = int(np.floor(sy)), int(np.floor(sx))
        fy, fx = sy - y0, sx - x0
        v = 0.0
        for (yy, xx, wgt) in ((y0, x0, (1 - fy) * (1 - fx)),
                              (y0, x0 + 1, (1 - fy) * fx),
                              (y0 + 1, x0, fy * (1 - fx)),
                              (y0 + 1, x0 + 1, fy * fx)):
            if 0 <= yy < h and 0 <= xx < w:
                v += wgt * img2d[yy, xx]
        return v

    for b in range(n):
        for oy in range(ho):
            for ox in range(wo):
                for o in range(cout):
                    g = o // opg
                    acc = 0.0
                    for ci in range(cin_pg):
                        cin = g * cin_pg + ci
                        dgi = cin // cpdg
                        for ti in range(kh):
                            for tj in range(kw):
                                tap = ti * kw + tj
                                oy_off = offset[b, oy, ox,
                                                dgi * 2 * k + 2 * tap]
                                ox_off = offset[b, oy, ox,
                                                dgi * 2 * k + 2 * tap + 1]
                                sy = (oy * stride - padding + ti * dilation
                                      + oy_off)
                                sx = (ox * stride - padding + tj * dilation
                                      + ox_off)
                                acc += weight[ti, tj, ci, o] * bilin(
                                    x[b, :, :, cin], sy, sx)
                    out[b, oy, ox, o] = acc
    return out
