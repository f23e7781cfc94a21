"""Input geometry, the device warp, colour augmentation and target
heatmaps, as plain NumPy and PyTorch (frozen copies of the formulations
CenterNet's ctdet uses: the reference's lib/utils/image.py, the image
cache's bilinear warp with cv2's zero border, the colour-aug blends)."""

from __future__ import annotations

import itertools

import numpy as np
import torch

PERMS = list(itertools.permutations((0, 1, 2)))
BGR_GRAY = (0.114, 0.587, 0.299)


def _third(a, b):
    d = a - b
    return b + np.array([-d[1], d[0]], dtype=np.float32)


def affine(center, scale, output_size, inv=False):
    """The 2x3 affine of CenterNet's get_affine_transform (rot 0, no
    shift): the square crop `scale` around `center` to `output_size`
    (w, h); inv=True maps the output back."""
    if not isinstance(scale, (np.ndarray, list)):
        scale = np.array([scale, scale], dtype=np.float32)
    dst_w, dst_h = output_size
    src = np.zeros((3, 2), np.float32)
    dst = np.zeros((3, 2), np.float32)
    src[0] = center
    src[1] = center + np.array([0, scale[0] * -0.5], np.float32)
    dst[0] = [dst_w * 0.5, dst_h * 0.5]
    dst[1] = np.array([dst_w * 0.5, dst_h * 0.5], np.float32) \
        + np.array([0, dst_w * -0.5], np.float32)
    src[2] = _third(src[0], src[1])
    dst[2] = _third(dst[0], dst[1])
    a, b = (dst, src) if inv else (src, dst)
    m = np.concatenate([a.astype(np.float64), np.ones((3, 1))], axis=1)
    return np.linalg.solve(m, b.astype(np.float64)).T.copy()


def letterbox(height, width, input_hw, down_ratio=4):
    """(model-input px -> frame px, output px -> frame px) of the scale-1
    fix_res letterbox of a (height, width) frame."""
    c = np.array([width / 2.0, height / 2.0], dtype=np.float32)
    s = max(height, width) * 1.0
    ih, iw = input_hw
    return (affine(c, s, [iw, ih], inv=True).astype(np.float32),
            affine(c, s, [iw // down_ratio, ih // down_ratio],
                   inv=True).astype(np.float32))


def warp(images, trans_inv, out_h, out_w, rows=None, extents=None):
    """Bilinear warp, one (2, 3) output px -> source px matrix per output,
    each of the four corners zeroed outside its source (cv2's constant
    zero border). images (N, H, W, C); rows (B,) the image each output
    reads (default b); extents (B, 2) the (h, w) a corner must lie in
    (default the images' H, W). Returns (B, out_h, out_w, C) f32."""
    n, h, w, c = images.shape
    dev = images.device
    t = torch.as_tensor(trans_inv, dtype=torch.float32, device=dev)
    b = t.shape[0]
    rows = torch.arange(b, device=dev) if rows is None \
        else torch.as_tensor(rows, device=dev).long()
    if extents is None:
        lim_h = torch.full((b,), h, device=dev)
        lim_w = torch.full((b,), w, device=dev)
    else:
        ext = torch.as_tensor(extents, device=dev).long()
        lim_h, lim_w = ext[:, 0], ext[:, 1]
    ys = torch.arange(out_h, dtype=torch.float32, device=dev)
    xs = torch.arange(out_w, dtype=torch.float32, device=dev)
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")
    sx = t[:, 0, 0, None, None] * gx + t[:, 0, 1, None, None] * gy \
        + t[:, 0, 2, None, None]
    sy = t[:, 1, 0, None, None] * gx + t[:, 1, 1, None, None] * gy \
        + t[:, 1, 2, None, None]
    x0, y0 = torch.floor(sx), torch.floor(sy)
    fx, fy = (sx - x0)[..., None], (sy - y0)[..., None]
    x0, y0 = x0.long(), y0.long()
    flat = images.reshape(n * h * w, c)
    lh, lw = lim_h[:, None, None], lim_w[:, None, None]
    base = rows[:, None, None] * (h * w)

    def at(yi, xi):
        ok = (yi >= 0) & (yi < lh) & (xi >= 0) & (xi < lw)
        v = flat[base + yi.clamp(0, h - 1) * w + xi.clamp(0, w - 1)]
        return v.float() * ok[..., None].float()

    top = at(y0, x0) * (1 - fx) + at(y0, x0 + 1) * fx
    bot = at(y0 + 1, x0) * (1 - fx) + at(y0 + 1, x0 + 1) * fx
    return top * (1 - fy) + bot * fy


def colour_normalise(img01, perm, alphas, light, mean, std):
    """CenterNet's colour augmentation (brightness, contrast, saturation
    in each image's permuted order, then PCA lighting) and normalisation
    of (B, H, W, 3) BGR images in [0, 1]."""
    dev = img01.device
    gray_w = torch.tensor(BGR_GRAY, dtype=torch.float32, device=dev)
    gs = img01 @ gray_w
    gs_mean = gs.mean(dim=(1, 2))
    order = torch.tensor(PERMS, device=dev)[torch.as_tensor(
        perm, device=dev).long()]
    alphas = torch.as_tensor(alphas, device=dev).float()
    img = img01
    for k in range(3):
        fid = order[:, k]
        alpha = 1.0 + alphas.gather(1, fid[:, None])[:, 0]
        a = alpha[:, None, None, None]
        out = []
        for i in range(img.shape[0]):
            f = int(fid[i])
            if f == 0:
                out.append(img[i] * a[i])
            elif f == 1:
                out.append(img[i] * a[i] + (1.0 - alpha[i]) * gs_mean[i])
            else:
                out.append(img[i] * a[i] + (1.0 - alpha[i]) * gs[i][..., None])
        img = torch.stack(out)
    img = img + torch.as_tensor(light, device=dev).float()[:, None, None, :]
    mean = torch.as_tensor(np.asarray(mean, np.float32), device=dev)
    std = torch.as_tensor(np.asarray(std, np.float32), device=dev)
    return (img - mean.reshape(3)) / std.reshape(3)


def _gaussian2d(diameter):
    sigma = diameter / 6
    m = (diameter - 1.0) / 2.0
    y, x = np.ogrid[-m:m + 1, -m:m + 1]
    g = np.exp(-(x * x + y * y) / (2 * sigma * sigma))
    g[g < np.finfo(g.dtype).eps * g.max()] = 0
    return g


def heatmaps(ct, radius, cls, mask, out_h, out_w, num_classes):
    """The ctdet focal-loss targets (N, out_h, out_w, classes): each
    object's gaussian max-splatted into its class (CenterNet's
    draw_umich_gaussian), on the host in float64."""
    ct, radius, cls, mask = (np.asarray(v) for v in (ct, radius, cls, mask))
    hm = np.zeros((ct.shape[0], num_classes, out_h, out_w), np.float64)
    for b in range(ct.shape[0]):
        for k in np.flatnonzero(mask[b]):
            r = int(radius[b, k])
            g = _gaussian2d(2 * r + 1)
            x, y = int(ct[b, k, 0]), int(ct[b, k, 1])
            left, right = min(x, r), min(out_w - x, r + 1)
            top, bottom = min(y, r), min(out_h - y, r + 1)
            dst = hm[b, int(cls[b, k]), y - top:y + bottom,
                     x - left:x + right]
            src = g[r - top:r + bottom, r - left:r + right]
            if min(src.shape) > 0 and min(dst.shape) > 0:
                np.maximum(dst, src, out=dst)
    return np.ascontiguousarray(hm.transpose(0, 2, 3, 1)).astype(np.float32)
