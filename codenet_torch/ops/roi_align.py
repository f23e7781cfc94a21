"""ROI-Align (the JAX package's ops/roi_align.py; reference lib/models/
external/src/roi_align_cuda.cpp:116-117 + roi_align_kernel.cu, Caffe2
style). The reference builds the op but no model of it calls it; it
completes the op inventory. Plain PyTorch, differentiable by autograd.

Semantics, as in the reference kernel:

- unaligned coordinates: ROI corners scaled by `spatial_scale`, no
  half-pixel shift, no rounding (roi_align_kernel.cu:186-190); a
  malformed ROI is forced to 1x1 (kernel.cu:197-198);
- the grid of each bin: `sampling_ratio` samples per axis if > 0, else
  ceil(roi_size / pooled_size) (kernel.cu:211-215), at the sub-cell
  centres, averaged;
- bilinear boundary: a sample with y outside [-1, H] (or x outside
  [-1, W]) adds 0; else y, x clamp to >= 0, and at the far edge the high
  corner collapses onto the low one (bilinear_interpolate,
  kernel.cu:43-96).

The adaptive grid is data dependent in the reference; as in the JAX
package a static `max_grid` lattice is built and the samples beyond each
ROI's count are masked.
"""

from __future__ import annotations

import torch


def _bilinear_gather(flat_img, h, w, y, x):
    """flat_img: (R, H*W, C); y, x: (R, ...) sample coordinates.
    Returns (R, ..., C) with the reference's boundary rules."""
    inside = (y >= -1.0) & (y <= h) & (x >= -1.0) & (x <= w)
    y = y.clamp(min=0.0)
    x = x.clamp(min=0.0)
    y0 = torch.floor(y).long().clamp(max=h - 1)
    x0 = torch.floor(x).long().clamp(max=w - 1)
    y1 = (y0 + 1).clamp(max=h - 1)
    x1 = (x0 + 1).clamp(max=w - 1)
    ly = torch.where(y0 == h - 1, 0.0, y - y0)
    lx = torch.where(x0 == w - 1, 0.0, x - x0)
    hy, hx = 1.0 - ly, 1.0 - lx
    c = flat_img.shape[-1]

    def take(yi, xi):
        idx = (yi * w + xi).reshape(yi.shape[0], -1, 1).expand(-1, -1, c)
        return torch.gather(flat_img, 1, idx).reshape(*yi.shape, c)

    out = (take(y0, x0) * (hy * hx)[..., None]
           + take(y0, x1) * (hy * lx)[..., None]
           + take(y1, x0) * (ly * hx)[..., None]
           + take(y1, x1) * (ly * lx)[..., None])
    return out * inside[..., None].to(out.dtype)


def roi_align(data, rois, pooled_height=7, pooled_width=7,
              spatial_scale=1.0 / 16, sampling_ratio=0, max_grid=8):
    """data: (N, H, W, C); rois: (R, 5) [batch_idx, x1, y1, x2, y2].
    Returns (R, pooled_height, pooled_width, C).

    `max_grid` bounds the adaptive grid (sampling_ratio == 0): a ROI that
    needs a finer one takes max_grid samples a bin and axis."""
    n, h, w, c = data.shape
    flat = data.reshape(n, h * w, c)
    ph_n, pw_n = pooled_height, pooled_width
    r = rois.shape[0]
    dev = data.device

    bi = torch.round(rois[:, 0]).long()
    x1 = rois[:, 1] * spatial_scale
    y1 = rois[:, 2] * spatial_scale
    x2 = rois[:, 3] * spatial_scale
    y2 = rois[:, 4] * spatial_scale
    roi_w = (x2 - x1).clamp(min=1.0)
    roi_h = (y2 - y1).clamp(min=1.0)
    bin_h = roi_h / ph_n
    bin_w = roi_w / pw_n

    if sampling_ratio > 0:
        gh = torch.full_like(bi, sampling_ratio)
        gw = torch.full_like(bi, sampling_ratio)
        g = sampling_ratio
    else:
        gh = torch.ceil(roi_h / ph_n).long().clamp(1, max_grid)
        gw = torch.ceil(roi_w / pw_n).long().clamp(1, max_grid)
        g = max_grid

    ar = torch.arange
    ph = ar(ph_n, dtype=rois.dtype, device=dev)
    pw = ar(pw_n, dtype=rois.dtype, device=dev)
    ig = ar(g, dtype=rois.dtype, device=dev)
    ys = (y1[:, None, None] + ph[None, :, None] * bin_h[:, None, None]
          + (ig[None, None, :] + 0.5) * bin_h[:, None, None]
          / gh[:, None, None].to(rois.dtype))                  # (R, P, G)
    xs = (x1[:, None, None] + pw[None, :, None] * bin_w[:, None, None]
          + (ig[None, None, :] + 0.5) * bin_w[:, None, None]
          / gw[:, None, None].to(rois.dtype))
    my = ar(g, device=dev)[None, None, :] < gh[:, None, None]  # (R, 1, G)
    mx = ar(g, device=dev)[None, None, :] < gw[:, None, None]

    shape = (r, ph_n, pw_n, g, g)
    yy = ys[:, :, None, :, None].expand(shape)
    xx = xs[:, None, :, None, :].expand(shape)
    mask = (my[:, :, None, :, None] & mx[:, None, :, None, :]).expand(
        shape).to(data.dtype)

    vals = _bilinear_gather(flat[bi], h, w, yy, xx)          # (R,P,P,G,G,C)
    vals = vals * mask[..., None]
    count = (gh * gw).to(data.dtype)
    return vals.sum(dim=(3, 4)) / count[:, None, None, None]
