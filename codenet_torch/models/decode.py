"""ctdet head decoding on (N, H, W, C) tensors, on the heads' device.

Port of the ctdet half of the JAX package's models/decode.py (reference
lib/models/decode.py): 3x3 max-pool peak-keep, top-k (pooled, or the
literal two-stage per-class then global), offset/size gathers, box
assembly, and the affine back-projection to original image pixels
(lib/utils/post_process.py:86-103) — detections leave as (N, K, 6)
[x1 y1 x2 y2 score cls].

`torch.topk` and `lax.top_k` may order exactly equal scores differently;
on tie-free maps both select and order the same detections.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def heat_nms(heat, kernel=3):
    """Peak-keep via 3x3 max-pool equality (reference decode.py:10-16)."""
    pad = (kernel - 1) // 2
    hmax = F.max_pool2d(heat.permute(0, 3, 1, 2), kernel, 1,
                        pad).permute(0, 2, 3, 1)
    return heat * (hmax == heat).to(heat.dtype)


def _gather_feat_nhwc(feat, ind):
    """Gather rows of an (N, H*W, C) feature at flat spatial indices (N, K)
    (the NHWC analogue of reference models/utils.py:14-29)."""
    return torch.gather(feat, 1,
                        ind.unsqueeze(-1).expand(-1, -1, feat.shape[-1]))


def topk(scores, k=40, method="pooled"):
    """Top-k over peak-masked heatmaps (reference decode.py:110-126).

    scores: (N, H, W, C). Returns (score, inds, clses, ys, xs), each
    (N, K); inds are flat y*W+x spatial indices.

    method="two_stage" is the literal reference structure: per-class top-k
    then a global top-k over the (C, K) winners. "pooled" computes the
    same selection over a 4x smaller domain: two strict 3x3 local maxima
    never share an aligned 2x2 block, so after `heat_nms` a 2x2/stride-2
    max-pool keeps every peak value (exact-tie plateaus collapse to one
    detection).
    """
    n, h, w, c = scores.shape
    if method == "pooled":
        ph, pw = -(-h // 2), -(-w // 2)
        if k <= ph * pw * c:
            return _topk_pooled(scores, k)
    percls = scores.reshape(n, h * w, c).transpose(1, 2)  # (N, C, H*W)
    topk_scores, topk_inds = torch.topk(percls, k)  # (N, C, K)
    topk_ys = torch.div(topk_inds, w, rounding_mode="floor").float()
    topk_xs = (topk_inds % w).float()

    topk_score, topk_ind = torch.topk(topk_scores.reshape(n, c * k), k)
    topk_clses = torch.div(topk_ind, k, rounding_mode="floor").int()

    def gather(t):
        return torch.gather(t.reshape(n, c * k), 1, topk_ind)

    return (topk_score, gather(topk_inds), topk_clses, gather(topk_ys),
            gather(topk_xs))


def _topk_pooled(scores, k):
    """Exact top-k via 2x2 max-pool domain reduction (see `topk`)."""
    n, h, w, c = scores.shape
    pooled = F.max_pool2d(scores.permute(0, 3, 1, 2), 2, 2,
                          ceil_mode=True).permute(0, 2, 3, 1)
    ph, pw = pooled.shape[1], pooled.shape[2]
    val, idx = torch.topk(pooled.reshape(n, ph * pw * c), k)  # (N, K)
    ch = (idx % c).int()
    sp = torch.div(idx, c, rounding_mode="floor")
    py = torch.div(sp, pw, rounding_mode="floor")
    px = sp % pw
    # recover the winning cell among the block's 4 children (first max
    # in (0,0),(0,1),(1,0),(1,1) order)
    by, bx = py * 2, px * 2
    cand_y = torch.stack([by, by, by + 1, by + 1], dim=-1)  # (N, K, 4)
    cand_x = torch.stack([bx, bx + 1, bx, bx + 1], dim=-1)
    valid = (cand_y < h) & (cand_x < w)
    cand_ind = cand_y.clamp(max=h - 1) * w + cand_x.clamp(max=w - 1)
    fi = cand_ind * c + ch.long()[..., None]
    g = torch.gather(scores.reshape(n, h * w * c), 1,
                     fi.reshape(n, k * 4)).reshape(n, k, 4)
    g = torch.where(valid, g, torch.finfo(scores.dtype).min)
    choice = torch.argmax(g, dim=-1, keepdim=True)  # (N, K, 1)
    ind = torch.gather(cand_ind, -1, choice)[..., 0]
    ys = torch.div(ind, w, rounding_mode="floor").float()
    xs = (ind % w).float()
    return val, ind, ch, ys, xs


def ctdet_decode(heat, wh, reg=None, cat_spec_wh=False, k=100):
    """CenterNet box decode (reference decode.py:474-505).

    heat: (N, H, W, C) post-sigmoid heatmap; wh: (N, H, W, 2 or 2C); reg:
    (N, H, W, 2) or None. Returns (N, K, 6) feature-space detections
    [x1 y1 x2 y2 score cls].
    """
    n = heat.shape[0]
    c = heat.shape[-1]
    heat = heat_nms(heat)
    scores, inds, clses, ys, xs = topk(heat, k)

    if reg is not None:
        regf = _gather_feat_nhwc(reg.reshape(n, -1, 2), inds)
        xs = xs[..., None] + regf[..., 0:1]
        ys = ys[..., None] + regf[..., 1:2]
    else:
        xs = xs[..., None] + 0.5
        ys = ys[..., None] + 0.5

    whc = wh.shape[-1]
    whf = _gather_feat_nhwc(wh.reshape(n, -1, whc), inds)
    if cat_spec_wh:
        whf = whf.reshape(n, k, c, 2)
        cls_idx = clses.long()[..., None, None].expand(n, k, 1, 2)
        whf = torch.gather(whf, 2, cls_idx).reshape(n, k, 2)

    bboxes = torch.cat([xs - whf[..., 0:1] / 2,
                        ys - whf[..., 1:2] / 2,
                        xs + whf[..., 0:1] / 2,
                        ys + whf[..., 1:2] / 2], dim=2)
    return torch.cat([bboxes, scores[..., None],
                      clses[..., None].float()], dim=2)


def apply_affine_points(pts, trans):
    """pts: (..., 2); trans: (..., 2, 3) mapping (x, y) -> (x', y'),
    broadcast against pts' leading dims."""
    x = trans[..., 0, 0] * pts[..., 0] + trans[..., 0, 1] * pts[..., 1] \
        + trans[..., 0, 2]
    y = trans[..., 1, 0] * pts[..., 0] + trans[..., 1, 1] * pts[..., 1] \
        + trans[..., 1, 2]
    return torch.stack([x, y], dim=-1)


def backproject_dets(dets, trans_inv, inv_scale=1.0):
    """ctdet_post_process without the per-class bucketing (reference
    post_process.py:86-103): map box corners through each image's inverse
    affine and divide by the test scale (reference detectors/ctdet.py:56).

    dets: (N, K, 6); trans_inv: (N, 2, 3). Returns (N, K, 6) in original
    image pixels.
    """
    t = trans_inv[:, None]  # (N, 1, 2, 3): one affine per image, all K
    p1 = apply_affine_points(dets[..., 0:2], t) * inv_scale
    p2 = apply_affine_points(dets[..., 2:4], t) * inv_scale
    return torch.cat([p1, p2, dets[..., 4:]], dim=-1)
