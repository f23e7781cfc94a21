"""Head decoding of the four CenterNet tasks on (N, H, W, C) tensors, on
the heads' device.

Port of the JAX package's models/decode.py (reference lib/models/
decode.py): 3x3 max-pool peak-keep, top-k (pooled, or the literal
two-stage per-class then global), offset/size gathers and box assembly.
ctdet detections leave back-projected to original image pixels
(lib/utils/post_process.py:86-103) as (N, K, 6) [x1 y1 x2 y2 score cls];
multi_pose ones as (N, K, 40) and ddd ones as (N, K, 18) in output-map
space (utils/post_process.py maps them back on the host); exdet
(ExtremeNet) ones as (N, num_dets, 14) from the K^4 lattice of extreme
point combinations, scored by the centre heatmap.

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


def topk_channel(scores, k=40, method="pooled"):
    """Per-class top-k without the global stage (reference decode.py:
    99-108). scores: (N, H, W, C) peak-masked maps. Returns (score, inds,
    ys, xs), each (N, C, K); inds are flat y*W+x per class. "pooled"
    selects over the 2x2 max-pooled maps, as `topk` does."""
    n, h, w, c = scores.shape
    if method == "pooled":
        ph, pw = -(-h // 2), -(-w // 2)
        if k <= ph * pw:
            return _topk_channel_pooled(scores, k)
    percls = scores.reshape(n, h * w, c).transpose(1, 2)
    topk_scores, topk_inds = torch.topk(percls, k)
    topk_ys = torch.div(topk_inds, w, rounding_mode="floor").float()
    topk_xs = (topk_inds % w).float()
    return topk_scores, topk_inds, topk_ys, topk_xs


def _topk_channel_pooled(scores, k):
    """Exact per-class top-k via 2x2 max-pool domain reduction."""
    n, h, w, c = scores.shape
    pooled = F.max_pool2d(scores.permute(0, 3, 1, 2), 2, 2,
                          ceil_mode=True)                 # (N, C, PH, PW)
    pw = pooled.shape[3]
    val, idx = torch.topk(pooled.reshape(n, c, -1), k)  # (N, C, K)
    py = torch.div(idx, pw, rounding_mode="floor")
    px = idx % pw
    by, bx = py * 2, px * 2
    cand_y = torch.stack([by, by, by + 1, by + 1], dim=-1)  # (N, C, K, 4)
    cand_x = torch.stack([bx, bx + 1, bx, bx + 1], dim=-1)
    valid = (cand_y < h) & (cand_x < w)
    cand_ind = cand_y.clamp(max=h - 1) * w + cand_x.clamp(max=w - 1)
    # gather from the native (H*W, C) layout: flat index sp*C + class
    cls_idx = torch.arange(c, device=scores.device)[None, :, None, None]
    fi = cand_ind * c + cls_idx
    g = torch.gather(scores.reshape(n, h * w * c), 1,
                     fi.reshape(n, c * k * 4)).reshape(n, c, k, 4)
    g = torch.where(valid, g, torch.finfo(scores.dtype).min)
    choice = torch.argmax(g, dim=-1, keepdim=True)  # (N, C, K, 1)
    ind = torch.gather(cand_ind, -1, choice)[..., 0]
    ys = torch.div(ind, w, rounding_mode="floor").float()
    xs = (ind % w).float()
    return val, ind, ys, xs


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


def multi_pose_decode(heat, wh, kps, reg=None, hm_hp=None, hp_offset=None,
                      k=100):
    """COCO-keypoints decode (reference decode.py:508-582). heat, hm_hp:
    post-sigmoid (N, H, W, 1) and (N, H, W, J); kps: (N, H, W, 2J) joint
    offsets from the centre. With hm_hp, each regressed joint snaps to
    the nearest peak of its joint's heatmap above 0.1, if that peak lies
    in the person box and within 0.3 * max(box w, h). Returns (N, K, 40):
    box (4), score, joints (2J), class, in output-map pixels."""
    n = heat.shape[0]
    num_joints = kps.shape[-1] // 2
    heat = heat_nms(heat)
    scores, inds, clses, ys, xs = topk(heat, k)

    kpsf = _gather_feat_nhwc(kps.reshape(n, -1, num_joints * 2), inds)
    kpsf = kpsf.reshape(n, k, num_joints, 2) \
        + torch.stack([xs, ys], dim=-1)[:, :, None, :]

    if reg is not None:
        regf = _gather_feat_nhwc(reg.reshape(n, -1, 2), inds)
        xs_c = xs[..., None] + regf[..., 0:1]
        ys_c = ys[..., None] + regf[..., 1:2]
    else:
        xs_c = xs[..., None] + 0.5
        ys_c = ys[..., None] + 0.5
    whf = _gather_feat_nhwc(wh.reshape(n, -1, 2), inds)
    bboxes = torch.cat([xs_c - whf[..., 0:1] / 2,
                        ys_c - whf[..., 1:2] / 2,
                        xs_c + whf[..., 0:1] / 2,
                        ys_c + whf[..., 1:2] / 2], dim=2)

    if hm_hp is not None:
        hm_hp = heat_nms(hm_hp)
        thresh = 0.1
        kps_reg = kpsf.transpose(1, 2)  # (N, J, K, 2)
        hm_score, hm_inds, hm_ys, hm_xs = topk_channel(hm_hp, k)
        if hp_offset is not None:
            hp_off = _gather_feat_nhwc(hp_offset.reshape(n, -1, 2),
                                       hm_inds.reshape(n, -1))
            hp_off = hp_off.reshape(n, num_joints, k, 2)
            hm_xs = hm_xs + hp_off[..., 0]
            hm_ys = hm_ys + hp_off[..., 1]
        else:
            hm_xs = hm_xs + 0.5
            hm_ys = hm_ys + 0.5
        # peaks at or below the threshold move far off (-10000) with score
        # -1: equal to one another, so ties among them change nothing
        mask = hm_score > thresh
        hm_score = torch.where(mask, hm_score, -1.0)
        hm_kps = torch.stack([torch.where(mask, hm_xs, -10000.0),
                              torch.where(mask, hm_ys, -10000.0)],
                             dim=-1)  # (N, J, K, 2)
        dist = torch.sqrt(((kps_reg[:, :, :, None, :]
                            - hm_kps[:, :, None, :, :]) ** 2).sum(-1))
        min_dist, min_ind = dist.min(dim=-1)  # (N, J, K_person)
        hm_score_sel = torch.gather(hm_score, 2, min_ind)
        hm_kps_sel = torch.gather(hm_kps, 2,
                                  min_ind[..., None].expand(-1, -1, -1, 2))
        left, top = bboxes[:, None, :, 0], bboxes[:, None, :, 1]
        right, bottom = bboxes[:, None, :, 2], bboxes[:, None, :, 3]
        bad = ((hm_kps_sel[..., 0] < left) | (hm_kps_sel[..., 0] > right)
               | (hm_kps_sel[..., 1] < top) | (hm_kps_sel[..., 1] > bottom)
               | (hm_score_sel < thresh)
               | (min_dist > torch.maximum(bottom - top, right - left)
                  * 0.3))
        kpsf = torch.where(bad[..., None], kps_reg,
                           hm_kps_sel).transpose(1, 2)

    return torch.cat([bboxes, scores[..., None],
                      kpsf.reshape(n, k, num_joints * 2),
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


def _directional_aggregate(heat, axis, reverse):
    """ExtremeNet's running conditional sum along `axis` (reference
    decode.py:19-74): ret[i] = heat[i] + ret[i-1] * (heat[i] >=
    heat[i-1]), walking back to front with `reverse`; returns ret - heat,
    in the JAX scan's order of f32 operations."""
    h = heat.movedim(axis, 0)
    order = range(h.shape[0] - 2, -1, -1) if reverse \
        else range(1, h.shape[0])
    start = h.shape[0] - 1 if reverse else 0
    prev, acc = h[start], h[start]
    extra = [None] * h.shape[0]
    extra[start] = torch.zeros_like(h[start])
    for i in order:
        x = h[i]
        acc = torch.where(x >= prev, acc, 0.0) + x
        prev = x
        extra[i] = acc - x
    return torch.stack(extra).movedim(0, axis)


def h_aggregate(heat, aggr_weight=0.1):
    """Horizontal edge aggregation, NHWC (W = axis 2)."""
    return (aggr_weight * _directional_aggregate(heat, 2, False)
            + aggr_weight * _directional_aggregate(heat, 2, True) + heat)


def v_aggregate(heat, aggr_weight=0.1):
    """Vertical edge aggregation, NHWC (H = axis 1)."""
    return (aggr_weight * _directional_aggregate(heat, 1, False)
            + aggr_weight * _directional_aggregate(heat, 1, True) + heat)


# cells of one image's K^4 lattice scored at a time (a slab of top points)
_LATTICE_CHUNK = 1 << 24
# ExtremeNet's geometric rejections (reference decode.py:351-354): the top
# point lies below another point, the left one right of another, the
# bottom one above another, the right one left of another (lattice axes
# t, l, b, r = 0, 1, 2, 3)
_GEOMETRY_TESTS = ((0, "y", torch.gt), (1, "x", torch.gt),
                   (2, "y", torch.lt), (3, "x", torch.lt))


def exct_decode(t_heat, l_heat, b_heat, r_heat, ct_heat,
                t_regr=None, l_regr=None, b_regr=None, r_regr=None,
                k=40, scores_thresh=0.1, center_thresh=0.1, aggr_weight=0.0,
                num_dets=1000, agnostic=False):
    """ExtremeNet decode (reference decode.py:281-433, and :129-279 with
    `agnostic`): the top K of each extreme-point heatmap, every (t, l, b,
    r) combination of them scored by the centre heatmap at the implied
    box centre, rejected (score minus one per failed class, geometry and
    threshold test), and the top `num_dets` kept.

    Heats are post-sigmoid (N, H, W, C); regressions (N, H, W, 2).
    Returns (N, num_dets, 14) [x1 y1 x2 y2 score tx ty lx ly bx by rx ry
    cls] in output-map pixels.

    The (N, K^4) score lattice is the one tensor of that size: it is
    built from the four K-vectors by broadcasting, and the centre scores
    and the rejection counts are added to it in place, a slab of top
    points at a time; only the winners' coordinates are gathered. The
    f32 operations are the JAX package's, in its order, so the scores are
    bit-equal on the same inputs.
    """
    n, height, width, _ = t_heat.shape
    if aggr_weight > 0:
        t_heat = h_aggregate(t_heat, aggr_weight)
        l_heat = v_aggregate(l_heat, aggr_weight)
        b_heat = h_aggregate(b_heat, aggr_weight)
        r_heat = v_aggregate(r_heat, aggr_weight)

    # the min(heat, 1) clamp makes exact-tie plateaus, which break the
    # pooled top-k's strict-peak premise: the literal two-stage top-k
    picks = [topk(torch.clamp(heat_nms(h), max=1.0), k, "two_stage")
             for h in (t_heat, l_heat, b_heat, r_heat)]
    (t_sc, t_inds, t_cls, t_ys, t_xs), (l_sc, l_inds, l_cls, l_ys, l_xs), \
        (b_sc, b_inds, b_cls, b_ys, b_xs), \
        (r_sc, r_inds, r_cls, r_ys, r_xs) = picks

    # box centres: x from (l, r), y from (t, b), truncated as int32
    ct_x = ((l_xs[:, :, None] + r_xs[:, None, :] + 0.5) / 2).to(torch.int32)
    ct_y = ((t_ys[:, :, None] + b_ys[:, None, :] + 0.5) / 2).to(torch.int32)
    if agnostic:
        ct_max, ct_arg = ct_heat.max(dim=-1)  # (N, H, W): first max
        ct_maps = ct_max[:, None]             # one map for every top point
    else:
        ct_maps = ct_heat.permute(0, 3, 1, 2)  # (N, C, H, W)

    # scores = (t + l + b + r + 2 ct) / 6 - rejected, over (t, l, b, r)
    scores = t_sc[:, :, None] + l_sc[:, None, :]
    scores = scores[..., None] + b_sc[:, None, None, :]
    scores = scores[..., None] + r_sc[:, None, None, None, :]  # (N, K^4)

    six = torch.full((), 6.0, dtype=scores.dtype, device=scores.device)
    step = max(1, min(k, _LATTICE_CHUNK // k ** 3))
    for i in range(n):
        cx_lr = ct_x[i].reshape(-1).long()  # (K_l * K_r)
        # per lattice axis (t, l, b, r): its class, score, y and x vectors
        vecs = [dict(cls=c[i], sc=sc[i], y=y[i], x=x[i]) for c, sc, y, x in (
            (t_cls, t_sc, t_ys, t_xs), (l_cls, l_sc, l_ys, l_xs),
            (b_cls, b_sc, b_ys, b_xs), (r_cls, r_sc, r_ys, r_xs))]
        for t0 in range(0, k, step):
            t1 = min(k, t0 + step)
            sl = scores[i, t0:t1]                 # (tk, K, K, K) view

            def part(axis, key):
                """Axis `axis`'s vector `key`, shaped to broadcast over
                the slab (the top points cut to t0:t1)."""
                vec = vecs[axis][key]
                shape = [1] * 4
                shape[axis] = -1
                return (vec[t0:t1] if axis == 0 else vec).reshape(shape)

            # centre scores: map rows at (t, b), then columns at (l, r)
            maps = ct_maps[i, torch.zeros(t1 - t0, dtype=torch.long,
                                          device=sl.device)] \
                if agnostic else ct_maps[i, t_cls[i, t0:t1].long()]
            rows = torch.gather(maps, 1, ct_y[i, t0:t1].long()[..., None]
                                .expand(-1, -1, width))  # (tk, K_b, W)
            ct = rows.index_select(2, cx_lr).reshape(
                t1 - t0, k, k, k).permute(0, 2, 1, 3)   # (tk, l, b, r)
            sl.add_(ct, alpha=2.0)
            # a tensor divisor: CUDA divides by a scalar as a product with
            # its reciprocal, one rounding off the CPU's (and XLA's) x / 6
            sl.div_(six)

            # one per failed test: the classes differ, a score is under
            # its threshold, or a point lies outside the others' box
            rej = torch.zeros(sl.shape, dtype=torch.uint8, device=sl.device)
            bad = torch.zeros(sl.shape, dtype=torch.bool, device=sl.device)
            if not agnostic:
                for other in (1, 2, 3):
                    bad |= part(0, "cls") != part(other, "cls")
                rej += bad
                bad.zero_()
            for axis in range(4):
                bad |= part(axis, "sc") < scores_thresh
            bad |= ct < center_thresh
            rej += bad
            for axis, key, op in _GEOMETRY_TESTS:
                bad.zero_()
                for other in range(4):
                    if other != axis:
                        bad |= op(part(axis, key), part(other, key))
                rej += bad
            sl.sub_(rej)

    scores_sel, inds = torch.topk(scores.reshape(n, -1), num_dets)
    ti = torch.div(inds, k ** 3, rounding_mode="floor")
    li = torch.div(inds, k ** 2, rounding_mode="floor") % k
    bi = torch.div(inds, k, rounding_mode="floor") % k
    ri = inds % k

    def point(xs, ys, regr, ind_k, idx):
        x, y = torch.gather(xs, 1, idx), torch.gather(ys, 1, idx)
        if regr is None:
            return x + 0.5, y + 0.5
        off = _gather_feat_nhwc(regr.reshape(n, -1, 2),
                                torch.gather(ind_k, 1, idx))
        return x + off[..., 0], y + off[..., 1]

    have_regr = all(r is not None for r in (t_regr, l_regr, b_regr, r_regr))
    tx, ty = point(t_xs, t_ys, t_regr if have_regr else None, t_inds, ti)
    lx, ly = point(l_xs, l_ys, l_regr if have_regr else None, l_inds, li)
    bx, by = point(b_xs, b_ys, b_regr if have_regr else None, b_inds, bi)
    rx, ry = point(r_xs, r_ys, r_regr if have_regr else None, r_inds, ri)
    if agnostic:
        cy = torch.gather(ct_y.reshape(n, -1), 1, ti * k + bi)
        cx = torch.gather(ct_x.reshape(n, -1), 1, li * k + ri)
        clses = torch.gather(ct_arg.reshape(n, -1), 1,
                             (cy * width + cx).long()).float()
    else:
        clses = torch.gather(t_cls, 1, ti).float()
    return torch.stack([lx, ty, rx, by, scores_sel, tx, ty, lx, ly, bx, by,
                        rx, ry, clses], dim=2)


def agnex_ct_decode(t_heat, l_heat, b_heat, r_heat, ct_heat, **kw):
    """Category-agnostic ExtremeNet decode (reference decode.py:129-279)."""
    return exct_decode(t_heat, l_heat, b_heat, r_heat, ct_heat,
                       agnostic=True, **kw)


def ddd_decode(heat, rot, depth, dim, wh=None, reg=None, k=40):
    """KITTI 3D decode (reference decode.py:435-471); heat post-sigmoid,
    depth already transformed. Returns (N, K, 18, or 16 without wh) [xs
    ys score rot(8) depth dim(3) (wh) cls] in output-map pixels."""
    n = heat.shape[0]
    heat = heat_nms(heat)
    scores, inds, clses, ys, xs = topk(heat, k)
    if reg is not None:
        regf = _gather_feat_nhwc(reg.reshape(n, -1, 2), inds)
        xs = xs[..., None] + regf[..., 0:1]
        ys = ys[..., None] + regf[..., 1:2]
    else:
        xs = xs[..., None] + 0.5
        ys = ys[..., None] + 0.5
    parts = [xs, ys, scores[..., None],
             _gather_feat_nhwc(rot.reshape(n, -1, 8), inds),
             _gather_feat_nhwc(depth.reshape(n, -1, 1), inds),
             _gather_feat_nhwc(dim.reshape(n, -1, 3), inds)]
    if wh is not None:
        parts.append(_gather_feat_nhwc(wh.reshape(n, -1, 2), inds))
    parts.append(clses[..., None].float())
    return torch.cat(parts, dim=2)
