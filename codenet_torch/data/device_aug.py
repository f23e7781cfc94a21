"""Input preprocessing and target rendering on the model's device (the JAX
package's data/device_aug.py).

The sampler ships the warped uint8 image (or, with the image cache, a row
index and a warp matrix: the warp runs here too) plus 7 floats of
per-sample augmentation state; brightness/contrast/saturation/PCA
lighting and the normalisation run on the device, and the ctdet
focal-loss heatmap is rendered there from the sparse object list. The
host draws the random state in the reference's order
(`draw_color_aug_params`), so the stream is the reference's.

Under --spatial_shard (`model_input`'s `band`) a rank makes only its band
of rows of each image: it slices a host image, or warps only those output
rows of a cached frame (the warp is per output pixel, so exact), and the
contrast's grey mean is the whole image's, its sum taken over the
spatial group.
"""

from __future__ import annotations

import itertools

import numpy as np
import torch

from .. import device_constant
from ..parallel.mesh import all_sum
from .affine import warp_affine_batch

# canonical order of the 3 ops; a permutation index selects execution order
PERMS = list(itertools.permutations((0, 1, 2)))
_PERM_INDEX = {p: i for i, p in enumerate(PERMS)}

# cv2 BGR2GRAY weights (images are BGR, as the reference reads them)
_BGR_GRAY = (0.114, 0.587, 0.299)


def draw_color_aug_params(data_rng, eig_val, eig_vec, py_random):
    """The reference color_aug's random state (image_aug.py:51-59): a
    shuffle of [brightness, contrast, saturation] on `py_random`, one
    uniform(-0.4, 0.4) per op in execution order, then the PCA lighting
    normal(0, 0.1) x 3, both on `data_rng`. Returns (perm_index,
    alphas_by_func_id[3], lighting_add[3])."""
    order = [0, 1, 2]
    py_random.shuffle(order)
    alphas = np.zeros(3, np.float32)
    for fid in order:
        alphas[fid] = data_rng.uniform(low=-0.4, high=0.4)
    light = data_rng.normal(scale=0.1, size=(3,))
    light_add = np.dot(eig_vec, eig_val * light).astype(np.float32)
    return _PERM_INDEX[tuple(order)], alphas, light_add


def identity_aug_params():
    """Zero alphas make every op multiplicative identity."""
    return 0, np.zeros(3, np.float32), np.zeros(3, np.float32)


def device_preprocess(inp_u8, perm, alphas, light_add, mean, std,
                      rows_of=None):
    """Colour aug + normalise. inp_u8: (B, H, W, 3) uint8 BGR; perm (B,)
    in [0, 6); alphas, light_add (B, 3); mean/std (3,). Returns (B, H, W,
    3) f32. `rows_of`: `color_norm_f01`'s."""
    return color_norm_f01(inp_u8.float() / 255.0, perm, alphas, light_add,
                          mean, std, rows_of)


def color_norm_f01(inp_f01, perm, alphas, light_add, mean, std,
                   rows_of=None):
    """Colour aug + normalise over f32 images already scaled to [0, 1].

    Every op is a blend `im * alpha + (1 - alpha) * base`: brightness with
    base 0, contrast with the image's grey mean, saturation with its grey
    map. Each image applies its three ops in its own permutation's order:
    step k of image b runs op PERMS[perm[b]][k], selected per image.
    rows_of: (height, spatial group) when the images are a band of rows of
    `height`-row images split over the group: the grey mean is then the
    band's sum summed over the group, over height * W pixels."""
    dev = inp_f01.device
    gray_w = device_constant(np.float32(_BGR_GRAY), dev)
    mean = device_constant(np.asarray(mean, np.float32).reshape(3), dev)
    std = device_constant(np.asarray(std, np.float32).reshape(3), dev)
    perm = torch.as_tensor(perm, device=dev).long()
    alphas = torch.as_tensor(alphas, device=dev).float()
    light_add = torch.as_tensor(light_add, device=dev).float()

    gs = inp_f01 @ gray_w                                 # (B, H, W)
    if rows_of is None:
        gs_mean = gs.mean(dim=(1, 2))                     # (B,)
    else:
        height, sp = rows_of
        gs_mean = all_sum(gs.sum(dim=(1, 2)), sp) / (height * gs.shape[2])
    order = device_constant(PERMS, dev)[perm]             # (B, 3)
    img = inp_f01
    for step in range(3):
        fid = order[:, step]                              # (B,)
        alpha = 1.0 + alphas.gather(1, fid[:, None])[:, 0]
        a = alpha[:, None, None, None]
        brightness = img * a
        contrast = img * a + ((1.0 - alpha) * gs_mean)[:, None, None, None]
        saturation = img * a + (1.0 - alpha)[:, None, None, None] \
            * gs[..., None]
        sel = fid[:, None, None, None]
        img = torch.where(sel == 0, brightness,
                          torch.where(sel == 1, contrast, saturation))
    img = img + light_add[:, None, None, :]
    return (img - mean) / std


# the batch fields that carry the image (the JAX mesh's _SPATIAL_FIELDS,
# and the cache batch's row index)
IMAGE_FIELDS = ("input", "input_u8", "img_idx")


def image_height(batch, out_hw=None):
    """The height of a batch's model input."""
    if "img_idx" in batch:
        return out_hw[0]
    return batch["input_u8" if "input_u8" in batch else "input"].shape[1]


def model_input(batch, mean, std, out_hw=None, cache=None, band=None):
    """The model input of a batch: the image cache path (img_idx + warp_ti
    against `cache`, the device-resident (N, Hc, Wc, 3) uint8 stack of
    data/device_cache.py, warped to out_hw = (input_h, input_w)), the
    device path (input_u8 + aug state) or a host-normalised f32 'input'.

    The cache path warps in f32 and is not rounded to uint8 (the host path
    is): the JAX package's arithmetic. band: ((lo, hi), spatial group),
    only rows [lo, hi) of each image (the module docstring)."""
    rows_of = None
    if band is not None:
        (lo, hi), sp = band
        rows_of = (image_height(batch, out_hw), sp)
    if "img_idx" in batch:
        oh, ow = out_hw
        row0 = 0
        if band is not None:
            row0, oh = lo, hi - lo
        warped = warp_affine_batch(cache, batch["warp_ti"], oh, ow,
                                   rows=batch["img_idx"], row0=row0) / 255.0
        return color_norm_f01(warped, batch["aug_perm"],
                              batch["aug_alphas"], batch["aug_light"],
                              mean, std, rows_of)
    if "input_u8" in batch:
        inp = batch["input_u8"]
        if band is not None:
            inp = inp[:, lo:hi]
        return device_preprocess(inp, batch["aug_perm"],
                                 batch["aug_alphas"], batch["aug_light"],
                                 mean, std, rows_of)
    return batch["input"] if band is None else batch["input"][:, lo:hi]


def render_umich_hm(ct, radius, cls, mask, out_h, out_w, num_classes):
    """The ctdet focal-loss heatmap from the sparse object list (reference
    draw_umich_gaussian, lib/utils/image.py:122-137), as a separable
    gaussian max-splatted per class.

    ct: (B, M, 2) int centres (x, y); radius, cls, mask: (B, M).
    Returns (B, out_h, out_w, num_classes) f32."""
    dev = ct.device
    ctf = ct.float()
    r = radius.float()[..., None]                       # (B, M, 1)
    sigma = (2.0 * r + 1.0) / 6.0
    denom = 2.0 * sigma * sigma
    ys = torch.arange(out_h, dtype=torch.float32, device=dev)
    xs = torch.arange(out_w, dtype=torch.float32, device=dev)
    dy = ys[None, None, :] - ctf[..., 1:2]              # (B, M, H)
    dx = xs[None, None, :] - ctf[..., 0:1]              # (B, M, W)
    gy = torch.exp(-dy * dy / denom) * (dy.abs() <= r)
    gx = torch.exp(-dx * dx / denom) * (dx.abs() <= r)
    gy = gy * mask.float()[..., None]
    chans = []
    for c in range(num_classes):
        gyc = gy * (cls == c).float()[..., None]
        chans.append(torch.amax(gyc[..., :, None] * gx[..., None, :],
                                dim=1))                  # (B, H, W)
    return torch.stack(chans, dim=-1)


def resolve_targets(batch, inp, down_ratio, num_classes, height=None):
    """Materialise dense targets shipped in sparse form; `height`: the
    whole input's, where `inp` is a band of its rows."""
    if "hm_ct" not in batch:
        return batch
    out_h = (height or inp.shape[1]) // down_ratio
    out_w = inp.shape[2] // down_ratio
    hm = render_umich_hm(batch["hm_ct"], batch["hm_radius"],
                         batch["hm_cls"], batch["reg_mask"], out_h, out_w,
                         num_classes)
    return dict(batch, hm=hm)
