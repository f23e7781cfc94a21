"""Affine geometry: the test-time coordinate contract.

The reference's 3-point affine construction (lib/utils/image.py:14-61),
shared by input warping and detection back-projection, solved in closed
form in numpy, plus a torch bilinear `warp_affine` that takes the place of
cv2.warpAffine in the detector's letterbox pre-process.
"""

from __future__ import annotations

import numpy as np
import torch


def get_dir(src_point, rot_rad):
    """Rotate a 2-vector (reference lib/utils/image.py:69-76)."""
    sn, cs = np.sin(rot_rad), np.cos(rot_rad)
    return [src_point[0] * cs - src_point[1] * sn,
            src_point[0] * sn + src_point[1] * cs]


def get_3rd_point(a, b):
    """Perpendicular third point (reference lib/utils/image.py:64-66)."""
    direct = a - b
    return b + np.array([-direct[1], direct[0]], dtype=np.float32)


def _solve_affine(src, dst):
    """Exact 2x3 affine mapping 3 src points to 3 dst points.

    Closed-form replacement for cv2.getAffineTransform: solve
    [x y 1] @ A.T = [x' y'] for the three point pairs.
    """
    src = np.asarray(src, dtype=np.float64)
    dst = np.asarray(dst, dtype=np.float64)
    ones = np.ones((3, 1), dtype=np.float64)
    m = np.concatenate([src, ones], axis=1)  # (3,3)
    t = np.linalg.solve(m, dst)
    return t.T.copy()  # (2,3) float64, same as cv2


def get_affine_transform(center, scale, rot, output_size,
                         shift=np.array([0, 0], dtype=np.float32), inv=0):
    """Affine from a (center, scale, rot) crop spec to an output rectangle.

    Bit-compatible with reference lib/utils/image.py:22-55.
    """
    if not isinstance(scale, np.ndarray) and not isinstance(scale, list):
        scale = np.array([scale, scale], dtype=np.float32)

    scale_tmp = scale
    src_w = scale_tmp[0]
    dst_w = output_size[0]
    dst_h = output_size[1]

    rot_rad = np.pi * rot / 180
    src_dir = get_dir([0, src_w * -0.5], rot_rad)
    dst_dir = np.array([0, dst_w * -0.5], np.float32)

    src = np.zeros((3, 2), dtype=np.float32)
    dst = np.zeros((3, 2), dtype=np.float32)
    src[0, :] = center + scale_tmp * shift
    src[1, :] = center + src_dir + scale_tmp * shift
    dst[0, :] = [dst_w * 0.5, dst_h * 0.5]
    dst[1, :] = np.array([dst_w * 0.5, dst_h * 0.5], np.float32) + dst_dir
    src[2:, :] = get_3rd_point(src[0, :], src[1, :])
    dst[2:, :] = get_3rd_point(dst[0, :], dst[1, :])

    if inv:
        return _solve_affine(dst, src)
    return _solve_affine(src, dst)


def affine_transform(pt, t):
    """Apply a 2x3 affine to one 2D point (reference image.py:58-61)."""
    new_pt = np.array([pt[0], pt[1], 1.0], dtype=np.float32).T
    new_pt = np.dot(t, new_pt)
    return new_pt[:2]


def transform_preds(coords, center, scale, output_size):
    """Map points from output-map space back to original image pixels.

    Reference lib/utils/image.py:14-19.
    """
    target_coords = np.zeros(coords.shape)
    trans = get_affine_transform(center, scale, 0, output_size, inv=1)
    for p in range(coords.shape[0]):
        target_coords[p, 0:2] = affine_transform(coords[p, 0:2], trans)
    return target_coords


def warp_affine(image, trans_inv, out_h, out_w):
    """Bilinear affine warp; `trans_inv` (2, 3) maps OUTPUT px -> INPUT px.

    cv2.warpAffine(..., INTER_LINEAR, borderValue=0) semantics for the
    scale/translate letterbox transforms the detector uses (reference
    lib/detectors/base_detector.py:62-66): each of the four corners is
    zeroed separately outside the source image. Interpolation is f32
    (cv2 interpolates uint8 in fixed point, so results differ from it by
    rounding).

    image: (H, W, C) float tensor. Returns (out_h, out_w, C) on its device.
    """
    h, w = image.shape[0], image.shape[1]
    t = torch.as_tensor(np.asarray(trans_inv, np.float32),
                        device=image.device)
    ys = torch.arange(out_h, dtype=torch.float32, device=image.device)
    xs = torch.arange(out_w, dtype=torch.float32, device=image.device)
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")  # (out_h, out_w)
    sx = t[0, 0] * gx + t[0, 1] * gy + t[0, 2]
    sy = t[1, 0] * gx + t[1, 1] * gy + t[1, 2]

    x0 = torch.floor(sx)
    y0 = torch.floor(sy)
    fx = (sx - x0).unsqueeze(-1).to(image.dtype)
    fy = (sy - y0).unsqueeze(-1).to(image.dtype)
    x0i = x0.long()
    y0i = y0.long()

    def sample(yi, xi):
        valid = (yi >= 0) & (yi < h) & (xi >= 0) & (xi < w)
        v = image[yi.clamp(0, h - 1), xi.clamp(0, w - 1)]
        return v * valid.unsqueeze(-1).to(image.dtype)

    top = sample(y0i, x0i) * (1 - fx) + sample(y0i, x0i + 1) * fx
    bot = sample(y0i + 1, x0i) * (1 - fx) + sample(y0i + 1, x0i + 1) * fx
    return top * (1 - fy) + bot * fy
