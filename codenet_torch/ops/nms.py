"""NMS and soft-NMS on the host (the JAX package's ops/nms.py; reference
lib/models/external/nms.pyx:24-391).

`nms`, `soft_nms`, `soft_nms_39` and `soft_nms_merge` send C-contiguous
float32 boxes to the native versions in `csrc/nms.cpp` (the port's copy
of the JAX package's native/nms.cpp), as the JAX package does; other
boxes take the numpy versions (`*_numpy`), which are also the plain
versions the native ones are held against. The native library is built
with the host C++ compiler on first use into
`codenet_torch/_build/libnms_<source hash>.so` and loaded with ctypes; a
failed build raises (it never falls back to numpy).

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

import ctypes
import threading
from pathlib import Path

import numpy as np

from ..utils import cxx

SOURCE = Path(__file__).resolve().parent.parent / "csrc" / "nms.cpp"
BUILD_DIR = cxx.BUILD_DIR
_lib = None
_lib_lock = threading.Lock()


def _get_lib():
    global _lib
    with _lib_lock:
        if _lib is None:
            lib = ctypes.CDLL(str(cxx.build_shared(SOURCE, "nms",
                                                    BUILD_DIR)))
            f32p = ctypes.POINTER(ctypes.c_float)
            lib.codenet_nms.restype = ctypes.c_long
            lib.codenet_nms.argtypes = [f32p, ctypes.c_long, ctypes.c_long,
                                        ctypes.c_float,
                                        ctypes.POINTER(ctypes.c_long)]
            lib.codenet_soft_nms.restype = ctypes.c_long
            lib.codenet_soft_nms.argtypes = [
                f32p, ctypes.c_long, ctypes.c_long] + [ctypes.c_float] * 3 \
                + [ctypes.c_int]
            lib.codenet_soft_nms_merge.restype = ctypes.c_long
            lib.codenet_soft_nms_merge.argtypes = \
                lib.codenet_soft_nms.argtypes + [ctypes.c_float]
            _lib = lib
    return _lib


def _native(boxes, min_cols):
    """True where `boxes` take the native route (the JAX package's rule:
    C-contiguous float32); a 2-D array of fewer than `min_cols` columns
    raises there, as the JAX package's native module does."""
    if boxes.dtype != np.float32 or not boxes.flags["C_CONTIGUOUS"]:
        return False
    if boxes.ndim != 2 or boxes.shape[1] < min_cols:
        raise ValueError("expected (N, >={}) float32 boxes, got {}".format(
            min_cols, boxes.shape))
    return True


def _ptr(boxes):
    return boxes.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


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
    Returns the kept row indices, highest score first (the native version
    orders tied scores by row; numpy's argsort its own way)."""
    if not _native(dets, 5):
        return nms_numpy(dets, thresh)
    keep = np.empty(dets.shape[0], np.int64)
    n = _get_lib().codenet_nms(
        _ptr(dets), dets.shape[0], dets.shape[1], float(thresh),
        keep.ctypes.data_as(ctypes.POINTER(ctypes.c_long)))
    return [int(i) for i in keep[:n]]


def nms_numpy(dets, thresh):
    """`nms` in numpy."""
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
    if not _native(boxes, 5):
        return soft_nms_numpy(boxes, sigma, Nt, threshold, method)
    n = _get_lib().codenet_soft_nms(_ptr(boxes), boxes.shape[0],
                                    boxes.shape[1], sigma, Nt, threshold,
                                    int(method))
    return list(range(n))


def soft_nms_numpy(boxes, sigma=0.5, Nt=0.3, threshold=0.001, method=0):
    """`soft_nms` in numpy."""
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
    if not _native(boxes, 39):
        return soft_nms_39_numpy(boxes, sigma, Nt, threshold, method)
    return soft_nms(boxes, sigma, Nt, threshold, method)


def soft_nms_39_numpy(boxes, sigma=0.5, Nt=0.3, threshold=0.001, method=0):
    """`soft_nms_39` in numpy."""
    return soft_nms_numpy(boxes, sigma, Nt, threshold, method)


def soft_nms_merge(boxes, sigma=0.5, Nt=0.3, threshold=0.001, method=0,
                   weight_exp=6.0):
    """Coordinate-merging soft-NMS (reference nms.pyx:277-391), in place on
    (N, 7) float boxes [x1 y1 x2 y2 score ts bs]: each kept box's corners
    become the mw = (1 - weight)^weight_exp weighted average over the boxes
    it overlaps, x1/y1 weighted by column 5 and x2/y2 by column 6.

    Reference quirks kept: the max-row swap and the tail-discard copy move
    columns 0-4 only (columns 5-6 stay with their rows), and the
    accumulators read the pre-swap row i's columns 5-6."""
    if not _native(boxes, 7):
        return soft_nms_merge_numpy(boxes, sigma, Nt, threshold, method,
                                    weight_exp)
    n = _get_lib().codenet_soft_nms_merge(
        _ptr(boxes), boxes.shape[0], boxes.shape[1], sigma, Nt, threshold,
        int(method), weight_exp)
    return list(range(n))


def soft_nms_merge_numpy(boxes, sigma=0.5, Nt=0.3, threshold=0.001,
                         method=0, weight_exp=6.0):
    """`soft_nms_merge` in numpy."""
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
