"""Affine geometry: the coordinate contract of training and test.

The reference's 3-point affine construction (lib/utils/image.py:14-61),
shared by input warping, target placement and detection back-projection,
solved in closed form in numpy; a torch bilinear warp, batched over images
with one matrix each (`warp_affine_batch`), that takes the place of
cv2.warpAffine in the detector's letterbox pre-process, the training
sampler and the device warp of the image cache; a torch bilinear
`resize_u8` in place of cv2.resize for test scales other than 1 and
--keep_res; and the CornerNet `gaussian_radius` and gaussian splat of the
ctdet targets.
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


def warp_affine_batch(images, trans_inv, out_h, out_w, rows=None, row0=0):
    """Bilinear affine warp of a batch, one (2, 3) matrix per output image;
    `trans_inv` maps OUTPUT px -> INPUT px.

    cv2.warpAffine(..., INTER_LINEAR, borderValue=0) semantics for the
    scale/translate transforms of the letterbox and the training crop
    (reference lib/detectors/base_detector.py:62-66): each of the four
    corners is zeroed separately outside the source image (its (H, W),
    padding included). Interpolation is in the images' float type, f32 for
    uint8 images (cv2 interpolates uint8 in fixed point, so results differ
    from it by rounding).

    images: (N, H, W, C) tensor; trans_inv: (B, 2, 3); rows: (B,) indices
    of the image each output warps (default: output b warps image b, B ==
    N). The four corners are four gathers over the whole batch from the
    flat (N * H * W, C) pixels, converted to float after the gather.
    row0: the first output row (rows [row0, row0 + out_h) of a taller
    output; each output pixel is warped on its own, so a band of rows is
    exactly those rows of the whole). Returns (B, out_h, out_w, C) on the
    images' device.
    """
    n, h, w, c = images.shape
    dev = images.device
    dtype = images.dtype if images.is_floating_point() else torch.float32
    t = torch.as_tensor(trans_inv, dtype=torch.float32, device=dev)
    b = t.shape[0]
    base = (torch.arange(b, device=dev) if rows is None
            else torch.as_tensor(rows, device=dev).long()) * (h * w)
    ys = torch.arange(row0, row0 + out_h, dtype=torch.float32, device=dev)
    xs = torch.arange(out_w, dtype=torch.float32, device=dev)
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")  # (out_h, out_w)

    def coef(i, j):
        return t[:, i, j, None, None]

    sx = coef(0, 0) * gx + coef(0, 1) * gy + coef(0, 2)  # (B, out_h, out_w)
    sy = coef(1, 0) * gx + coef(1, 1) * gy + coef(1, 2)

    x0 = torch.floor(sx)
    y0 = torch.floor(sy)
    fx = (sx - x0).unsqueeze(-1).to(dtype)
    fy = (sy - y0).unsqueeze(-1).to(dtype)
    x0i = x0.long()
    y0i = y0.long()
    flat = images.reshape(n * h * w, c)
    base = base[:, None, None]

    def sample(yi, xi):
        valid = (yi >= 0) & (yi < h) & (xi >= 0) & (xi < w)
        idx = base + yi.clamp(0, h - 1) * w + xi.clamp(0, w - 1)
        v = flat[idx].to(dtype)                          # (B, oh, ow, C)
        return v * valid.unsqueeze(-1).to(dtype)

    top = sample(y0i, x0i) * (1 - fx) + sample(y0i, x0i + 1) * fx
    bot = sample(y0i + 1, x0i) * (1 - fx) + sample(y0i + 1, x0i + 1) * fx
    return top * (1 - fy) + bot * fy


def warp_affine(image, trans_inv, out_h, out_w):
    """`warp_affine_batch` of one (H, W, C) image with one (2, 3) matrix;
    returns (out_h, out_w, C)."""
    return warp_affine_batch(image[None],
                             np.asarray(trans_inv, np.float32)[None],
                             out_h, out_w)[0]


def resize_u8(image, new_w, new_h):
    """Bilinear resize of a uint8 (H, W, C) numpy image to (new_h, new_w):
    the stand-in for cv2.resize(INTER_LINEAR) on a machine without cv2.
    Half-pixel centres, no antialias (torch `interpolate`, align_corners
    False), rounded half to even and clamped to uint8; the identity at the
    same size. cv2 interpolates uint8 in 11-bit fixed point: the two differ
    by at most one level."""
    h, w = image.shape[0], image.shape[1]
    if (new_h, new_w) == (h, w):
        return image.copy()
    x = torch.from_numpy(np.ascontiguousarray(image)).permute(2, 0, 1)
    out = torch.nn.functional.interpolate(
        x[None].float(), size=(new_h, new_w), mode="bilinear",
        align_corners=False, antialias=False)[0]
    return out.round_().clamp_(0, 255).to(torch.uint8).permute(1, 2, 0) \
        .contiguous().numpy()


def invert_affine(trans):
    """Inverse of a 2x3 affine (cv2.invertAffineTransform), float64."""
    m = np.vstack([np.asarray(trans, np.float64), [0.0, 0.0, 1.0]])
    return np.linalg.inv(m)[:2]


def warp_affine_u8(image, trans_inv, out_h, out_w):
    """`warp_affine` of a uint8 (H, W, C) numpy image on the CPU, rounded
    (half to even) and clamped back to uint8 numpy: the stand-in for
    cv2.warpAffine(INTER_LINEAR, borderValue=0) on a machine without cv2.
    OpenCV 5.0 gives the same pixels; builds that snap coordinates to
    1/32 px and interpolate in fixed point differ by a few levels at
    edges."""
    warped = warp_affine(torch.from_numpy(np.ascontiguousarray(image)),
                         trans_inv, out_h, out_w)
    return warped.round_().clamp_(0, 255).to(torch.uint8).numpy()


def gaussian_radius(det_size, min_overlap=0.7):
    """CornerNet min-IoU-preserving radius (reference image.py:90-110)."""
    height, width = det_size

    a1 = 1
    b1 = height + width
    c1 = width * height * (1 - min_overlap) / (1 + min_overlap)
    sq1 = np.sqrt(b1 ** 2 - 4 * a1 * c1)
    r1 = (b1 + sq1) / 2

    a2 = 4
    b2 = 2 * (height + width)
    c2 = (1 - min_overlap) * width * height
    sq2 = np.sqrt(b2 ** 2 - 4 * a2 * c2)
    r2 = (b2 + sq2) / 2

    a3 = 4 * min_overlap
    b3 = -2 * min_overlap * (height + width)
    c3 = (min_overlap - 1) * width * height
    sq3 = np.sqrt(b3 ** 2 - 4 * a3 * c3)
    r3 = (b3 + sq3) / 2
    return min(r1, r2, r3)


def gaussian2D(shape, sigma=1):
    """Unnormalised 2D gaussian, tails below eps * max zeroed (reference
    lib/utils/image.py:113-119)."""
    m, n = [(ss - 1.0) / 2.0 for ss in shape]
    y, x = np.ogrid[-m:m + 1, -n:n + 1]
    h = np.exp(-(x * x + y * y) / (2 * sigma * sigma))
    h[h < np.finfo(h.dtype).eps * h.max()] = 0
    return h


def draw_umich_gaussian(heatmap, center, radius, k=1):
    """Max-splat a gaussian onto a (H, W) heatmap in place (reference
    lib/utils/image.py:122-137): the host-drawn heatmaps of
    --host_normalize ctdet batches and of every multi_pose batch."""
    diameter = 2 * radius + 1
    gaussian = gaussian2D((diameter, diameter), sigma=diameter / 6)

    x, y = int(center[0]), int(center[1])
    height, width = heatmap.shape[0:2]

    left, right = min(x, radius), min(width - x, radius + 1)
    top, bottom = min(y, radius), min(height - y, radius + 1)

    masked_heatmap = heatmap[y - top:y + bottom, x - left:x + right]
    masked_gaussian = gaussian[radius - top:radius + bottom,
                               radius - left:radius + right]
    if min(masked_gaussian.shape) > 0 and min(masked_heatmap.shape) > 0:
        np.maximum(masked_heatmap, masked_gaussian * k, out=masked_heatmap)
    return heatmap


def draw_msra_gaussian(heatmap, center, sigma):
    """Max-splat an unnormalised gaussian of std `sigma` (a 6 sigma + 1
    square, no radius cut) onto a (H, W) heatmap in place (reference
    lib/utils/image.py:172-193): the --mse_loss targets. As there, sigma 0
    gives a NaN centre (0 / 0)."""
    tmp_size = sigma * 3
    mu_x = int(center[0] + 0.5)
    mu_y = int(center[1] + 0.5)
    w, h = heatmap.shape[0], heatmap.shape[1]
    ul = [int(mu_x - tmp_size), int(mu_y - tmp_size)]
    br = [int(mu_x + tmp_size + 1), int(mu_y + tmp_size + 1)]
    if ul[0] >= h or ul[1] >= w or br[0] < 0 or br[1] < 0:
        return heatmap
    size = 2 * tmp_size + 1
    x = np.arange(0, size, 1, np.float32)
    y = x[:, np.newaxis]
    x0 = y0 = size // 2
    g = np.exp(-((x - x0) ** 2 + (y - y0) ** 2) / (2 * sigma ** 2))
    g_x = max(0, -ul[0]), min(br[0], h) - ul[0]
    g_y = max(0, -ul[1]), min(br[1], w) - ul[1]
    img_x = max(0, ul[0]), min(br[0], h)
    img_y = max(0, ul[1]), min(br[1], w)
    heatmap[img_y[0]:img_y[1], img_x[0]:img_x[1]] = np.maximum(
        heatmap[img_y[0]:img_y[1], img_x[0]:img_x[1]],
        g[g_y[0]:g_y[1], g_x[0]:g_x[1]])
    return heatmap


def draw_dense_reg(regmap, heatmap, center, value, radius, is_offset=False):
    """Splat `value` into the (D, H, W) regmap in place, within `radius`
    of `center`, where this object's gaussian is at least the heatmap
    already drawn (reference lib/utils/image.py:140-169): --dense_wh and
    --dense_hp. is_offset (D = 2): each cell's value is taken relative to
    the cell."""
    diameter = 2 * radius + 1
    gaussian = gaussian2D((diameter, diameter), sigma=diameter / 6)
    value = np.array(value, dtype=np.float32).reshape(-1, 1, 1)
    dim = value.shape[0]
    reg = np.ones((dim, diameter * 2 + 1, diameter * 2 + 1),
                  dtype=np.float32) * value
    if is_offset and dim == 2:
        delta = np.arange(diameter * 2 + 1) - radius
        reg[0] = reg[0] - delta.reshape(1, -1)
        reg[1] = reg[1] - delta.reshape(-1, 1)

    x, y = int(center[0]), int(center[1])
    height, width = heatmap.shape[0:2]

    left, right = min(x, radius), min(width - x, radius + 1)
    top, bottom = min(y, radius), min(height - y, radius + 1)

    masked_heatmap = heatmap[y - top:y + bottom, x - left:x + right]
    masked_regmap = regmap[:, y - top:y + bottom, x - left:x + right]
    masked_gaussian = gaussian[radius - top:radius + bottom,
                               radius - left:radius + right]
    masked_reg = reg[:, radius - top:radius + bottom,
                     radius - left:radius + right]
    if min(masked_gaussian.shape) > 0 and min(masked_heatmap.shape) > 0:
        idx = (masked_gaussian >= masked_heatmap).reshape(
            1, masked_gaussian.shape[0], masked_gaussian.shape[1])
        masked_regmap = (1 - idx) * masked_regmap + idx * masked_reg
    regmap[:, y - top:y + bottom, x - left:x + right] = masked_regmap
    return regmap
