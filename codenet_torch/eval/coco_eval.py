"""COCO detection/keypoint evaluation, self-contained numpy.

The port's own copy of the JAX package's eval/coco_eval.py, a functional
port of pycocotools.cocoeval.COCOeval (bbox + keypoints), which the
reference calls for COCO mAP (reference lib/datasets/dataset/coco.py:
121-130, coco_hp.py) and which the port does not depend on. Implements the
standard protocol: 10 IoU thresholds 0.50:0.95, 101 recall points, area
ranges, maxDets [1,10,100] (bbox) / [20] (keypoints), crowd-ignore matching,
and the 12-number (bbox) / 10-number (kps) summary.
"""

from __future__ import annotations

import json

import numpy as np

from ..data.coco_io import CocoIndex

OKS_SIGMAS = np.array([
    .26, .25, .25, .35, .35, .79, .79, .72, .72, .62, .62, 1.07, 1.07,
    .87, .87, .89, .89]) / 10.0


def bbox_iou_xywh(dts, gts, iscrowd):
    """IoU between det and gt boxes in xywh (pycocotools maskUtils.iou
    semantics: crowd gt -> intersection / det area), vectorized (D, G).
    Held to the pycocotools protocol by tests/test_torch_coco_eval.py."""
    d = np.asarray(dts, np.float64).reshape(-1, 4)
    g = np.asarray(gts, np.float64).reshape(-1, 4)
    if len(d) == 0 or len(g) == 0:
        return np.zeros((len(d), len(g)))
    ix = (np.minimum(d[:, None, 0] + d[:, None, 2], g[None, :, 0]
                     + g[None, :, 2])
          - np.maximum(d[:, None, 0], g[None, :, 0]))
    iy = (np.minimum(d[:, None, 1] + d[:, None, 3], g[None, :, 1]
                     + g[None, :, 3])
          - np.maximum(d[:, None, 1], g[None, :, 1]))
    inter = np.where((ix > 0) & (iy > 0), ix * iy, 0.0)
    darea = (d[:, 2] * d[:, 3])[:, None]
    garea = (g[:, 2] * g[:, 3])[None, :]
    crowd = np.asarray(iscrowd, bool)[None, :]
    union = np.where(crowd, darea, darea + garea - inter)
    return np.where(union > 0, inter / np.where(union > 0, union, 1.0), 0.0)


def oks_iou(dts_kps, gts_kps, gts_boxes, gts_areas):
    """Object-keypoint similarity (pycocotools computeOks)."""
    ious = np.zeros((len(dts_kps), len(gts_kps)))
    vars_ = (OKS_SIGMAS * 2) ** 2
    k = len(OKS_SIGMAS)
    for j, (gkp, bb, area) in enumerate(zip(gts_kps, gts_boxes, gts_areas)):
        g = np.asarray(gkp)
        xg, yg, vg = g[0::3], g[1::3], g[2::3]
        k1 = int(np.count_nonzero(vg > 0))
        x0, x1 = bb[0] - bb[2], bb[0] + bb[2] * 2
        y0, y1 = bb[1] - bb[3], bb[1] + bb[3] * 2
        for i, dkp in enumerate(dts_kps):
            d = np.asarray(dkp)
            xd, yd = d[0::3], d[1::3]
            if k1 > 0:
                dx = xd - xg
                dy = yd - yg
            else:
                z = np.zeros(k)
                dx = np.maximum(z, x0 - xd) + np.maximum(z, xd - x1)
                dy = np.maximum(z, y0 - yd) + np.maximum(z, yd - y1)
            e = (dx ** 2 + dy ** 2) / vars_ / (area + np.spacing(1)) / 2
            if k1 > 0:
                e = e[vg > 0]
            ious[i, j] = np.sum(np.exp(-e)) / e.shape[0]
    return ious


class CocoDetEval:
    """COCOeval-compatible evaluator over a CocoIndex GT + results.json."""

    def __init__(self, coco_gt: CocoIndex, results, iou_type="bbox"):
        self.gt = coco_gt
        if isinstance(results, str):
            with open(results) as f:
                results = json.load(f)
        # results.json entries carry no "id"/"area" (reference
        # coco.py:90-112 format); assign sequential ids and derive areas
        # exactly like pycocotools COCO.loadRes — which OVERWRITES any
        # caller-supplied area/bbox unconditionally (keypoint results get
        # both from the keypoint x/y extents), so a results list that
        # already carries them scores identically to the reference
        prepared = []
        for i, d in enumerate(results):
            d = dict(d)
            d["id"] = i + 1
            if iou_type == "keypoints":
                s = d["keypoints"]
                x, y = s[0::3], s[1::3]
                x0, x1 = float(np.min(x)), float(np.max(x))
                y0, y1 = float(np.min(y)), float(np.max(y))
                d["area"] = (x1 - x0) * (y1 - y0)
                d["bbox"] = [x0, y0, x1 - x0, y1 - y0]
            else:
                d["area"] = d["bbox"][2] * d["bbox"][3]
            prepared.append(d)
        self.dt = prepared
        self.iou_type = iou_type
        self.img_ids = sorted(coco_gt.getImgIds())
        self.cat_ids = sorted(coco_gt.getCatIds()) or sorted(
            {d["category_id"] for d in results})
        self.iou_thrs = np.linspace(0.5, 0.95, 10)
        self.rec_thrs = np.linspace(0.0, 1.0, 101)
        if iou_type == "keypoints":
            self.max_dets = [20]
            self.area_rngs = [[0, 1e10], [32 ** 2, 96 ** 2], [96 ** 2, 1e10]]
            self.area_lbls = ["all", "medium", "large"]
        else:
            self.max_dets = [1, 10, 100]
            self.area_rngs = [[0, 1e10], [0, 32 ** 2], [32 ** 2, 96 ** 2],
                              [96 ** 2, 1e10]]
            self.area_lbls = ["all", "small", "medium", "large"]
        self.eval_imgs = {}
        self.precision = None
        self.recall = None

    # -- grouping ----------------------------------------------------------
    def _gts(self, img_id, cat_id):
        # one-time (img, cat) index: the per-area-range re-evaluation only
        # rewrites "_ignore", so the prepared dicts are shared across calls
        if not hasattr(self, "_gt_index"):
            self._gt_index = {}
            for a in self.gt.loadAnns(
                    self.gt.getAnnIds(imgIds=self.img_ids)):
                a = dict(a)
                a["area"] = a.get("area", a["bbox"][2] * a["bbox"][3])
                a["iscrowd"] = a.get("iscrowd", 0)
                a["ignore"] = a.get("ignore", 0) or a["iscrowd"]
                if self.iou_type == "keypoints":
                    a["ignore"] = a["ignore"] or (
                        a.get("num_keypoints", 0) == 0)
                self._gt_index.setdefault(
                    (a["image_id"], a["category_id"]), []).append(a)
        return self._gt_index.get((img_id, cat_id), [])

    def _dts(self, img_id, cat_id):
        key = (img_id, cat_id)
        if not hasattr(self, "_dt_index"):
            self._dt_index = {}
            for d in self.dt:
                self._dt_index.setdefault(
                    (d["image_id"], d["category_id"]), []).append(d)
        return self._dt_index.get(key, [])

    # -- per-image evaluation ----------------------------------------------
    def _evaluate_img(self, img_id, cat_id, area_rng, max_det):
        gts = self._gts(img_id, cat_id)
        dts = self._dts(img_id, cat_id)
        if len(gts) == 0 and len(dts) == 0:
            return None

        for g in gts:
            g["_ignore"] = 1 if (g["ignore"] or g["area"] < area_rng[0]
                                 or g["area"] > area_rng[1]) else 0
        gt_order = np.argsort([g["_ignore"] for g in gts], kind="mergesort")
        gts = [gts[i] for i in gt_order]
        dt_order = np.argsort([-d["score"] for d in dts], kind="mergesort")
        dts = [dts[i] for i in dt_order[:max_det]]
        iscrowd = [int(g["iscrowd"]) for g in gts]

        # IoU is area-range independent: compute once per (img, cat) on the
        # score-sorted dts / unsorted gts and permute (pycocotools
        # computeIoU caching)
        if not hasattr(self, "_iou_cache"):
            self._iou_cache = {}
        key = (img_id, cat_id)
        if key not in self._iou_cache:
            base_gts = self._gts(img_id, cat_id)  # unsorted GT order
            base_dts = dts  # score-sorted, max_det-truncated (line 163);
            # max_det is max(self.max_dets) on every evaluate() call, so
            # the cached table rows always cover the current slice
            if len(base_dts) and len(base_gts):
                if self.iou_type == "keypoints":
                    tab = oks_iou([d["keypoints"] for d in base_dts],
                                  [g["keypoints"] for g in base_gts],
                                  [g["bbox"] for g in base_gts],
                                  [g["area"] for g in base_gts])
                else:
                    tab = bbox_iou_xywh(
                        [d["bbox"] for d in base_dts],
                        [g["bbox"] for g in base_gts],
                        [int(g["iscrowd"]) for g in base_gts])
            else:
                tab = np.zeros((len(base_dts), len(base_gts)))
            self._iou_cache[key] = tab
        ious = self._iou_cache[key][:len(dts)][:, gt_order] \
            if self._iou_cache[key].size else self._iou_cache[key]

        T = len(self.iou_thrs)
        G = len(gts)
        D = len(dts)
        gtm = np.zeros((T, G))
        dtm = np.zeros((T, D))
        gt_ig = np.array([g["_ignore"] for g in gts])
        dt_ig = np.zeros((T, D))
        for tind, t in enumerate(self.iou_thrs):
            for dind in range(D):
                iou = min(t, 1 - 1e-10)
                m = -1
                for gind in range(G):
                    if gtm[tind, gind] > 0 and not iscrowd[gind]:
                        continue
                    if m > -1 and gt_ig[m] == 0 and gt_ig[gind] == 1:
                        break
                    if ious[dind, gind] < iou:
                        continue
                    iou = ious[dind, gind]
                    m = gind
                if m == -1:
                    continue
                dt_ig[tind, dind] = gt_ig[m]
                dtm[tind, dind] = gts[m]["id"]
                gtm[tind, m] = dts[dind]["id"]
        # unmatched dets outside the area range are ignored (loadRes-derived
        # "area": bbox w*h, or the keypoint-extent box for keypoints)
        a = np.array([d["area"] < area_rng[0] or d["area"] > area_rng[1]
                      for d in dts])
        if D:
            dt_ig = np.logical_or(
                dt_ig, np.logical_and(dtm == 0, np.tile(a, (T, 1))))
        return {
            "dt_scores": np.array([d["score"] for d in dts]),
            "dtm": dtm, "dt_ig": dt_ig, "gt_ig": gt_ig,
            "num_gt": int((gt_ig == 0).sum()),
        }

    def evaluate(self):
        for ci, cat_id in enumerate(self.cat_ids):
            for ai, area_rng in enumerate(self.area_rngs):
                for img_id in self.img_ids:
                    self.eval_imgs[(cat_id, ai, img_id)] = \
                        self._evaluate_img(img_id, cat_id, area_rng,
                                           max(self.max_dets))

    def accumulate(self):
        T = len(self.iou_thrs)
        R = len(self.rec_thrs)
        K = len(self.cat_ids)
        A = len(self.area_rngs)
        M = len(self.max_dets)
        precision = -np.ones((T, R, K, A, M))
        recall = -np.ones((T, K, A, M))
        for ki, cat_id in enumerate(self.cat_ids):
            for ai in range(A):
                per_img = [self.eval_imgs.get((cat_id, ai, i))
                           for i in self.img_ids]
                per_img = [e for e in per_img if e is not None]
                if not per_img:
                    continue
                for mi, max_det in enumerate(self.max_dets):
                    scores = np.concatenate(
                        [e["dt_scores"][:max_det] for e in per_img])
                    order = np.argsort(-scores, kind="mergesort")
                    dtm = np.concatenate(
                        [e["dtm"][:, :max_det] for e in per_img],
                        axis=1)[:, order]
                    dt_ig = np.concatenate(
                        [e["dt_ig"][:, :max_det] for e in per_img],
                        axis=1)[:, order]
                    npig = sum(e["num_gt"] for e in per_img)
                    if npig == 0:
                        continue
                    tps = np.logical_and(dtm, np.logical_not(dt_ig))
                    fps = np.logical_and(np.logical_not(dtm),
                                         np.logical_not(dt_ig))
                    tp_sum = np.cumsum(tps, axis=1).astype(float)
                    fp_sum = np.cumsum(fps, axis=1).astype(float)
                    for t in range(T):
                        tp = tp_sum[t]
                        fp = fp_sum[t]
                        nd = len(tp)
                        rc = tp / npig
                        pr = tp / (fp + tp + np.spacing(1))
                        recall[t, ki, ai, mi] = rc[-1] if nd else 0
                        q = np.zeros(R)
                        pr = pr.tolist()
                        for i in range(nd - 1, 0, -1):
                            if pr[i] > pr[i - 1]:
                                pr[i - 1] = pr[i]
                        inds = np.searchsorted(rc, self.rec_thrs, side="left")
                        for ri, pi in enumerate(inds):
                            if pi < nd:
                                q[ri] = pr[pi]
                        precision[t, :, ki, ai, mi] = q
        self.precision = precision
        self.recall = recall

    def _summary(self, ap=1, iou_thr=None, area="all", max_det=100):
        ai = self.area_lbls.index(area)
        mi = self.max_dets.index(max_det)
        if ap:
            s = self.precision
            if iou_thr is not None:
                t = np.where(np.isclose(self.iou_thrs, iou_thr))[0]
                s = s[t]
            s = s[:, :, :, ai, mi]
        else:
            s = self.recall
            if iou_thr is not None:
                t = np.where(np.isclose(self.iou_thrs, iou_thr))[0]
                s = s[t]
            s = s[:, :, ai, mi]
        valid = s[s > -1]
        return float(np.mean(valid)) if valid.size else -1.0

    def summarize(self):
        if self.precision is None:
            self.accumulate()
        if self.iou_type == "keypoints":
            md = self.max_dets[0]
            stats = {
                "AP": self._summary(1, None, "all", md),
                "AP50": self._summary(1, 0.5, "all", md),
                "AP75": self._summary(1, 0.75, "all", md),
                "APm": self._summary(1, None, "medium", md),
                "APl": self._summary(1, None, "large", md),
                "AR": self._summary(0, None, "all", md),
                "AR50": self._summary(0, 0.5, "all", md),
                "AR75": self._summary(0, 0.75, "all", md),
                "ARm": self._summary(0, None, "medium", md),
                "ARl": self._summary(0, None, "large", md),
            }
        else:
            stats = {
                "AP": self._summary(1, None, "all", 100),
                "AP50": self._summary(1, 0.5, "all", 100),
                "AP75": self._summary(1, 0.75, "all", 100),
                "APs": self._summary(1, None, "small", 100),
                "APm": self._summary(1, None, "medium", 100),
                "APl": self._summary(1, None, "large", 100),
                "AR1": self._summary(0, None, "all", 1),
                "AR10": self._summary(0, None, "all", 10),
                "AR100": self._summary(0, None, "all", 100),
                "ARs": self._summary(0, None, "small", 100),
                "ARm": self._summary(0, None, "medium", 100),
                "ARl": self._summary(0, None, "large", 100),
            }
        for k, v in stats.items():
            print(" {} = {:.3f}".format(k, v))
        return stats
