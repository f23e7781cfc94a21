"""The reference's flip-test serving of raw frames: the scale-1 letterbox
warp, normalisation, the flipped copy, the network in eval mode, the
sigmoid heatmap and the flip-averaged heads (CenterNet's ctdet detector),
then every output position's box mapped back to frame pixels. Where the
detector keeps the top K peaks, the reference keeps the dense maps, so
that a served detection can be found wherever it lies, and the score of
each image's (K + K/10)-th peak."""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from . import geometry


class Dense(NamedTuple):
    """The reference's dense maps of N frames, on an (H, W) output."""
    boxes: torch.Tensor   # (N, H*W, 4) each position's box in frame pixels
    scores: torch.Tensor  # (N, H*W, C) the flip-averaged sigmoid heatmap
    local: torch.Tensor   # (N, H*W, C) its 3x3 maximum around each position
    kth: torch.Tensor     # (N,) the (K + K/10)-th peak's score
    hw: tuple
    rival: torch.Tensor   # (N, H*W, C) the largest of the 8 neighbours'


def neighbour_max(maps):
    """(N, C, H, W) -> the largest of each position's 8 neighbours (-inf
    beyond the border)."""
    h, w = maps.shape[2:]
    pad = F.pad(maps, (1, 1, 1, 1), value=float("-inf"))
    return torch.stack([pad[:, :, 1 + dy:1 + dy + h, 1 + dx:1 + dx + w]
                        for dy in (-1, 0, 1) for dx in (-1, 0, 1)
                        if dy or dx]).amax(0)


def block_peaks(dense, i):
    """Frame i's peaks, an exact-tie plateau taken once in each aligned
    2x2 block (its first maximum), as the detector's decode takes them:
    (scores (P,), flat positions (P,), classes (P,)), every block's."""
    h, w = dense.hw
    scores, local = dense.scores[i], dense.local[i]
    c = scores.shape[1]
    peaks = (scores * (local == scores)).t().reshape(c, h, w)
    blocks, arg = F.max_pool2d(peaks[None], 2, 2, ceil_mode=True,
                               return_indices=True)
    per_class = blocks.shape[2] * blocks.shape[3]
    cls = torch.arange(c, device=scores.device).repeat_interleave(per_class)
    return blocks.reshape(-1), arg.reshape(-1), cls


@torch.no_grad()
def dense_detections(arch, frames, cfg, params, buffers, k,
                     precision="f32"):
    """The reference's `Dense` maps of a list of (h, w, 3) uint8 BGR
    frames, on the device of `params`, through configuration `cfg` of
    architecture module `arch`."""
    dev = next(iter(params.values())).device
    ih, iw = cfg["input_hw"]
    warp_ti, back = zip(*(geometry.letterbox(f.shape[0], f.shape[1],
                                             (ih, iw), cfg["down_ratio"])
                          for f in frames))
    hmax = max(f.shape[0] for f in frames)
    wmax = max(f.shape[1] for f in frames)
    stack = np.zeros((len(frames), hmax, wmax, 3), np.uint8)
    for i, f in enumerate(frames):
        stack[i, :f.shape[0], :f.shape[1]] = f
    extents = np.asarray([f.shape[:2] for f in frames], np.int64)
    img = geometry.warp(torch.as_tensor(stack, device=dev),
                        np.stack(warp_ti), ih, iw, extents=extents)
    mean = torch.as_tensor(np.asarray(cfg["mean"], np.float32), device=dev)
    std = torch.as_tensor(np.asarray(cfg["std"], np.float32), device=dev)
    img = ((img / 255.0 - mean) / std).permute(0, 3, 1, 2)
    x = torch.cat([img, torch.flip(img, dims=[3])]).contiguous()
    net = arch.Net(cfg, None, precision)
    out = net.forward(x, params, dict(buffers), train=False)
    n = len(frames)
    hm = out["hm"].sigmoid()
    hm = (hm[:n] + torch.flip(hm[n:], dims=[3])) / 2
    wh = (out["wh"][:n] + torch.flip(out["wh"][n:], dims=[3])) / 2
    reg = out["reg"][:n]
    c, h, w = hm.shape[1:]
    ys, xs = torch.meshgrid(torch.arange(h, device=dev).float(),
                            torch.arange(w, device=dev).float(),
                            indexing="ij")
    cx, cy = xs + reg[:, 0], ys + reg[:, 1]
    corners = torch.stack([cx - wh[:, 0] / 2, cy - wh[:, 1] / 2,
                           cx + wh[:, 0] / 2, cy + wh[:, 1] / 2], -1)
    t = torch.as_tensor(np.stack(back), device=dev)[:, None, None]

    def to_frame(px, py):
        return (t[..., 0, 0] * px + t[..., 0, 1] * py + t[..., 0, 2],
                t[..., 1, 0] * px + t[..., 1, 1] * py + t[..., 1, 2])
    x1, y1 = to_frame(corners[..., 0], corners[..., 1])
    x2, y2 = to_frame(corners[..., 2], corners[..., 3])
    boxes = torch.stack([x1, y1, x2, y2], -1).reshape(n, h * w, 4)
    local = F.max_pool2d(hm, 3, 1, 1)
    peaks = hm * (local == hm)
    # the (K + K/10)-th peak, an exact-tie plateau (the letterbox's
    # constant bands) counted once in each aligned 2x2 block, as the
    # detector's decode collapses it (two strict 3x3 maxima never share
    # such a block). The tenth's slack: two neighbours within rounding of
    # each other make one peak or the other, which changes the set of
    # peaks, so a served top K may reach a peak or two past the K-th
    blocks = F.max_pool2d(peaks, 2, 2, ceil_mode=True)
    kth = torch.topk(blocks.reshape(n, -1), k + k // 10).values[:, -1]

    def flat(maps):
        return maps.permute(0, 2, 3, 1).reshape(n, h * w, c)
    return Dense(boxes, flat(hm), flat(local), kth, (h, w),
                 flat(neighbour_max(hm)))


def top_detections(dense, k):
    """Per frame the (k, 6) [x1 y1 x2 y2 score class] detections of the
    dense maps: the k largest peak scores over every position and class
    (CenterNet's ctdet decode), as `block_peaks` takes the peaks."""
    out = []
    for i in range(dense.boxes.shape[0]):
        score, loc, cls = block_peaks(dense, i)
        val, idx = torch.topk(score, k)
        out.append(torch.cat([dense.boxes[i][loc[idx]], val[:, None],
                              cls[idx, None].float()], 1))
    return out
