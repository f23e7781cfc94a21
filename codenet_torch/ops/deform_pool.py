"""Deformable position-sensitive ROI pooling, the DCNv2 op (the JAX
package's ops/deform_pool.py; reference lib/models/external/src/
dcn_deform_pool_cuda.cpp:81-85 + dcn_deform_pool_cuda_kernel.cu). The
reference builds the op but no model of it calls it; it completes the op
inventory. Plain PyTorch, channels-last, differentiable by autograd.

Per ROI, a pooled_size x pooled_size grid of bins; each bin of output
channel `ctop` averages sample_per_part^2 bilinear samples of its
position-sensitive input channel, moved by the learnt per-part (dy, dx)
offset scaled by trans_std and the ROI's size. The whole lattice (ROI,
bin, channel, sample) is one gather.
"""

from __future__ import annotations

import torch


def deform_psroi_pooling(data, rois, trans=None, output_dim=1,
                         pooled_size=7, group_size=1, part_size=None,
                         sample_per_part=4, spatial_scale=1.0 / 16,
                         trans_std=0.1):
    """data: (N, H, W, C) with C == output_dim * group_size^2; rois:
    (R, 5) [batch_idx, x1, y1, x2, y2] in image coordinates; trans:
    (R, part, part, 2 * output_dim) or None (no offsets). Returns
    (R, pooled_size, pooled_size, output_dim).

    As in the JAX package, the batch index truncates, the average divides
    by all sample_per_part^2 samples (those outside the map add 0), and
    bin (ph, pw) of channel ctop reads trans[..., 2 * ctop] and
    [..., 2 * ctop + 1] (clamped to trans's last channel, as a JAX
    gather clamps)."""
    part = part_size or pooled_size
    p, d, sp = pooled_size, output_dim, sample_per_part
    n, h, w, c = data.shape
    dev, dt = data.device, data.dtype

    bi = rois[:, 0].long()
    x1 = rois[:, 1] * spatial_scale - 0.5
    y1 = rois[:, 2] * spatial_scale - 0.5
    x2 = (rois[:, 3] + 1.0) * spatial_scale - 0.5
    y2 = (rois[:, 4] + 1.0) * spatial_scale - 0.5
    roi_w = (x2 - x1).clamp(min=0.1)
    roi_h = (y2 - y1).clamp(min=0.1)
    bin_w, bin_h = roi_w / p, roi_h / p
    sub_w, sub_h = bin_w / sp, bin_h / sp

    ph = torch.arange(p, device=dev)
    ct = torch.arange(d, device=dev)
    # (P, P, D) lattice of bins and output channels
    phg = ph[:, None, None].expand(p, p, d)
    pwg = ph[None, :, None].expand(p, p, d)
    ctg = ct[None, None, :].expand(p, p, d)
    cin = (ctg * group_size + (phg * group_size) // p) * group_size \
        + (pwg * group_size) // p

    def per_roi(v):  # (R,) -> (R, 1, 1, 1)
        return v[:, None, None, None]

    if trans is not None:
        part_h = (phg * part) // p
        part_w = (pwg * part) // p
        last = trans.shape[-1] - 1
        tr = trans[:, part_h, part_w]                      # (R, P, P, D, T)
        ty = torch.gather(tr, 4, (2 * ctg).clamp(max=last)[None, ..., None]
                          .expand(len(rois), -1, -1, -1, 1))[..., 0]
        tx = torch.gather(tr, 4, (2 * ctg + 1).clamp(max=last)[None, ...,
                          None].expand(len(rois), -1, -1, -1, 1))[..., 0]
        dy = ty * trans_std * per_roi(roi_h)
        dx = tx * trans_std * per_roi(roi_w)
    else:
        dy = dx = torch.zeros((), dtype=dt, device=dev)

    # sample lattice: (R, P, P, D, S, S)
    s = torch.arange(sp, dtype=dt, device=dev) + 0.5
    yb = per_roi(y1) + phg.to(dt) * per_roi(bin_h)           # (R, P, P, D)
    xb = per_roi(x1) + pwg.to(dt) * per_roi(bin_w)

    def lattice(v):  # (R, P, P, D) -> (R, P, P, D, 1, 1)
        return v[..., None, None] if v.dim() else v

    yy = (lattice(yb) + s[:, None] * lattice(per_roi(sub_h))
          + lattice(dy))
    xx = (lattice(xb) + s[None, :] * lattice(per_roi(sub_w))
          + lattice(dx))
    inside = (yy > -1) & (yy < h) & (xx > -1) & (xx < w)
    yc = yy.clamp(0.0, h - 1.0)
    xc = xx.clamp(0.0, w - 1.0)
    y0 = torch.floor(yc)
    x0 = torch.floor(xc)
    fy = yc - y0
    fx = xc - x0
    y0 = y0.long()
    x0 = x0.long()
    flat = data.reshape(-1)
    base = per_roi(bi)[..., None, None] * (h * w * c) \
        + cin[None, ..., None, None]

    def corner(yi, xi, wgt):
        valid = (yi >= 0) & (yi < h) & (xi >= 0) & (xi < w)
        idx = base + (yi.clamp(0, h - 1) * w + xi.clamp(0, w - 1)) * c
        return flat[idx] * (wgt * valid.to(dt))

    v = (corner(y0, x0, (1 - fy) * (1 - fx))
         + corner(y0, x0 + 1, (1 - fy) * fx)
         + corner(y0 + 1, x0, fy * (1 - fx))
         + corner(y0 + 1, x0 + 1, fy * fx))
    v = v * inside.to(dt)
    return v.sum(dim=(4, 5)) / (sp ** 2)
