"""NMS and soft-NMS on the host, in numpy (the JAX package's ops/nms.py
numpy versions; reference lib/models/external/nms.pyx:24-391).

The reference's caller-visible semantics are kept exactly: ctdet's
`merge_outputs` calls `soft_nms` for its in-place score decay and ignores
the returned keep list (reference detectors/ctdet.py:64-65). A row whose
score falls below the threshold is overwritten by the last live row and
the logical N shrinks, while the array keeps its physical size; the max
row is swapped to the front before each pass.

These run on the host over the per-class boxes of a request after decode
(at most K per scale, so up to 5 x 100 boxes of one class at five test
scales); their cost is quadratic in that count.
"""

from __future__ import annotations

import numpy as np


def _weight(ov, sigma, Nt, method):
    """Decay of a box overlapping the current max box by IoU `ov`: linear
    (1), gaussian (2) or hard (0)."""
    if method == 1:
        return 1 - ov if ov > Nt else 1.0
    if method == 2:
        return np.exp(-(ov * ov) / sigma)
    return 0.0 if ov > Nt else 1.0


def _overlap(boxes, pos, tx1, ty1, tx2, ty2):
    """IoU of row `pos` with the box (tx1, ty1, tx2, ty2), in the
    reference's +1 pixel convention; None where they do not intersect."""
    x1, y1, x2, y2 = boxes[pos, 0], boxes[pos, 1], boxes[pos, 2], \
        boxes[pos, 3]
    area = (x2 - x1 + 1) * (y2 - y1 + 1)
    iw = min(tx2, x2) - max(tx1, x1) + 1
    if iw <= 0:
        return None
    ih = min(ty2, y2) - max(ty1, y1) + 1
    if ih <= 0:
        return None
    ua = (tx2 - tx1 + 1) * (ty2 - ty1 + 1) + area - iw * ih
    return iw * ih / ua


def nms(dets, thresh):
    """Greedy hard NMS (reference nms.pyx:24-75) over (N, >=5) dets.
    Returns the kept row indices, highest score first."""
    x1, y1, x2, y2 = dets[:, 0], dets[:, 1], dets[:, 2], dets[:, 3]
    scores = dets[:, 4]
    areas = (x2 - x1 + 1) * (y2 - y1 + 1)
    order = scores.argsort()[::-1]

    keep = []
    suppressed = np.zeros(dets.shape[0], dtype=bool)
    for _i in range(len(order)):
        i = order[_i]
        if suppressed[i]:
            continue
        keep.append(int(i))
        rest = order[_i + 1:]
        rest = rest[~suppressed[rest]]
        if rest.size == 0:
            continue
        xx1 = np.maximum(x1[i], x1[rest])
        yy1 = np.maximum(y1[i], y1[rest])
        xx2 = np.minimum(x2[i], x2[rest])
        yy2 = np.minimum(y2[i], y2[rest])
        w = np.maximum(0.0, xx2 - xx1 + 1)
        h = np.maximum(0.0, yy2 - yy1 + 1)
        inter = w * h
        ovr = inter / (areas[i] + areas[rest] - inter)
        suppressed[rest[ovr >= thresh]] = True
    return keep


def soft_nms(boxes, sigma=0.5, Nt=0.3, threshold=0.001, method=0):
    """Soft-NMS (reference nms.pyx:77-170), in place on (N, 5) float boxes
    [x1 y1 x2 y2 score]; method 0 hard, 1 linear, 2 gaussian. Returns
    list(range(N')), N' the shrunk logical count."""
    n = boxes.shape[0]
    i = 0
    while i < n:
        maxpos = i + int(np.argmax(boxes[i:n, 4]))
        if maxpos != i:
            boxes[[i, maxpos]] = boxes[[maxpos, i]].copy()
        tx1, ty1, tx2, ty2 = boxes[i, 0], boxes[i, 1], boxes[i, 2], \
            boxes[i, 3]
        pos = i + 1
        while pos < n:
            ov = _overlap(boxes, pos, tx1, ty1, tx2, ty2)
            if ov is not None:
                boxes[pos, 4] = _weight(ov, sigma, Nt, method) * boxes[pos, 4]
                if boxes[pos, 4] < threshold:
                    boxes[pos] = boxes[n - 1].copy()
                    n -= 1
                    pos -= 1
            pos += 1
        i += 1
    return list(range(n))


def soft_nms_39(boxes, sigma=0.5, Nt=0.3, threshold=0.001, method=0):
    """The 39-column keypoint variant (reference nms.pyx:172-275): rows
    carry bbox(4) + score + 17 keypoints (34); the score logic and the
    whole-row swaps are `soft_nms`'s."""
    return soft_nms(boxes, sigma, Nt, threshold, method)


def soft_nms_merge(boxes, sigma=0.5, Nt=0.3, threshold=0.001, method=0,
                   weight_exp=6.0):
    """Coordinate-merging soft-NMS (reference nms.pyx:277-391), in place on
    (N, 7) float boxes [x1 y1 x2 y2 score ts bs]: each kept box's corners
    become the mw = (1 - weight)^weight_exp weighted average over the boxes
    it overlaps, x1/y1 weighted by column 5 and x2/y2 by column 6.

    Reference quirks kept: the max-row swap and the tail-discard copy move
    columns 0-4 only (columns 5-6 stay with their rows), and the
    accumulators read the pre-swap row i's columns 5-6."""
    n = boxes.shape[0]
    i = 0
    while i < n:
        maxpos = i + int(np.argmax(boxes[i:n, 4]))
        if maxpos != i:
            tmp = boxes[i, 0:5].copy()
            boxes[i, 0:5] = boxes[maxpos, 0:5]
            boxes[maxpos, 0:5] = tmp
        mx1 = boxes[i, 0] * boxes[i, 5]
        my1 = boxes[i, 1] * boxes[i, 5]
        mx2 = boxes[i, 2] * boxes[i, 6]
        my2 = boxes[i, 3] * boxes[i, 6]
        mts, mbs = boxes[i, 5], boxes[i, 6]
        tx1, ty1, tx2, ty2 = boxes[i, 0], boxes[i, 1], boxes[i, 2], \
            boxes[i, 3]
        pos = i + 1
        while pos < n:
            ov = _overlap(boxes, pos, tx1, ty1, tx2, ty2)
            if ov is not None:
                weight = _weight(ov, sigma, Nt, method)
                mw = (1 - weight) ** weight_exp
                mx1 += boxes[pos, 0] * boxes[pos, 5] * mw
                my1 += boxes[pos, 1] * boxes[pos, 5] * mw
                mx2 += boxes[pos, 2] * boxes[pos, 6] * mw
                my2 += boxes[pos, 3] * boxes[pos, 6] * mw
                mts += boxes[pos, 5] * mw
                mbs += boxes[pos, 6] * mw
                boxes[pos, 4] = weight * boxes[pos, 4]
                if boxes[pos, 4] < threshold:
                    boxes[pos, 0:5] = boxes[n - 1, 0:5]
                    n -= 1
                    pos -= 1
            pos += 1
        boxes[i, 0] = mx1 / mts
        boxes[i, 1] = my1 / mts
        boxes[i, 2] = mx2 / mbs
        boxes[i, 3] = my2 / mbs
        i += 1
    return list(range(n))
