"""Pascal VOC detection AP, in-process.

Port of the reference's scoring chain
(tools/reval.py -> voc_eval_lib/datasets/pascal_voc.py:222-268 ->
voc_eval.py:31-213): per-class greedy matching at IoU>0.5 with the devkit's
inclusive (+1) box areas, difficult-GT exclusion, and the VOC07 11-point AP
for 2007. Ground truth comes from the same COCO-format json the training
pipeline reads (the reference re-parses VOC XMLs; the boxes are identical).
"""

from __future__ import annotations

import json

import numpy as np

from ..data.coco_io import CocoIndex


def voc_ap(rec, prec, use_07_metric=False):
    """AP from PR points (reference voc_eval.py:31-64)."""
    if use_07_metric:
        ap = 0.0
        for t in np.arange(0.0, 1.1, 0.1):
            if np.sum(rec >= t) == 0:
                p = 0
            else:
                p = np.max(prec[rec >= t])
            ap = ap + p / 11.0
        return ap
    mrec = np.concatenate(([0.0], rec, [1.0]))
    mpre = np.concatenate(([0.0], prec, [0.0]))
    for i in range(mpre.size - 1, 0, -1):
        mpre[i - 1] = np.maximum(mpre[i - 1], mpre[i])
    i = np.where(mrec[1:] != mrec[:-1])[0]
    return np.sum((mrec[i + 1] - mrec[i]) * mpre[i + 1])


def _eval_class(dets_per_image, gts_per_image, ovthresh=0.5,
                use_07_metric=True):
    """Greedy match one class (reference voc_eval.py:126-213).

    dets_per_image: {img_id: (M, 5) [x1 y1 x2 y2 score]}.
    gts_per_image: {img_id: (bbox (G, 4), difficult (G,))}.
    """
    class_recs = {}
    npos = 0
    for img_id, (bbox, difficult) in gts_per_image.items():
        det = [False] * len(bbox)
        npos += int((~difficult).sum())
        class_recs[img_id] = {"bbox": bbox, "difficult": difficult,
                              "det": det}

    image_ids = []
    confidence = []
    boxes = []
    for img_id, dets in dets_per_image.items():
        for d in dets:
            image_ids.append(img_id)
            confidence.append(d[4])
            boxes.append(d[:4])
    confidence = np.array(confidence)
    BB = np.array(boxes)

    nd = len(image_ids)
    tp = np.zeros(nd)
    fp = np.zeros(nd)
    if BB.shape[0] > 0:
        sorted_ind = np.argsort(-confidence)
        BB = BB[sorted_ind, :]
        image_ids = [image_ids[x] for x in sorted_ind]

        for d in range(nd):
            R = class_recs.get(image_ids[d],
                               {"bbox": np.zeros((0, 4)),
                                "difficult": np.zeros(0, bool),
                                "det": []})
            bb = BB[d, :].astype(float)
            ovmax = -np.inf
            BBGT = R["bbox"].astype(float)
            jmax = -1
            if BBGT.size > 0:
                ixmin = np.maximum(BBGT[:, 0], bb[0])
                iymin = np.maximum(BBGT[:, 1], bb[1])
                ixmax = np.minimum(BBGT[:, 2], bb[2])
                iymax = np.minimum(BBGT[:, 3], bb[3])
                iw = np.maximum(ixmax - ixmin + 1.0, 0.0)
                ih = np.maximum(iymax - iymin + 1.0, 0.0)
                inters = iw * ih
                uni = ((bb[2] - bb[0] + 1.0) * (bb[3] - bb[1] + 1.0)
                       + (BBGT[:, 2] - BBGT[:, 0] + 1.0)
                       * (BBGT[:, 3] - BBGT[:, 1] + 1.0) - inters)
                overlaps = inters / uni
                ovmax = np.max(overlaps)
                jmax = int(np.argmax(overlaps))
            if ovmax > ovthresh:
                if not R["difficult"][jmax]:
                    if not R["det"][jmax]:
                        tp[d] = 1.0
                        R["det"][jmax] = True
                    else:
                        fp[d] = 1.0
            else:
                fp[d] = 1.0

    fp = np.cumsum(fp)
    tp = np.cumsum(tp)
    rec = tp / float(max(npos, 1))
    prec = tp / np.maximum(tp + fp, np.finfo(np.float64).eps)
    return rec, prec, voc_ap(rec, prec, use_07_metric)


def voc_eval_from_coco_json(results_json, gt_json, class_names,
                            ovthresh=0.5, use_07_metric=True, quiet=False):
    """Score a reference-format results.json against COCO-format VOC GT.

    results_json: the per-class list-of-lists written by
    PascalVOC.save_results (reference pascal.py:58-75): index [cls_1based]
    [img_index] -> list of [x1, y1, x2, y2, score] — img_index follows the
    sorted image-id order.

    Returns {"AP50": mean_ap, "per_class": {name: ap}}.
    """
    if isinstance(results_json, str):
        with open(results_json) as f:
            detections = json.load(f)
    else:
        detections = results_json
    gt = CocoIndex(gt_json)
    img_ids = sorted(gt.getImgIds())

    aps = {}
    for cls_ind, cls_name in enumerate(class_names):
        cls_1based = cls_ind + 1
        gts_per_image = {}
        for img_id in img_ids:
            anns = gt.loadAnns(gt.getAnnIds(imgIds=[img_id]))
            boxes = []
            difficult = []
            for ann in anns:
                if int(ann["category_id"]) != cls_1based:
                    continue
                x, y, w, h = ann["bbox"]
                boxes.append([x, y, x + w, y + h])
                difficult.append(bool(ann.get("difficult",
                                              ann.get("ignore", 0))))
            gts_per_image[img_id] = (
                np.array(boxes, np.float64).reshape(-1, 4),
                np.array(difficult, bool))

        dets_per_image = {}
        cls_dets = detections[cls_1based]
        for i, img_id in enumerate(img_ids):
            d = np.array(cls_dets[i], np.float64).reshape(-1, 5)
            if len(d):
                dets_per_image[img_id] = d
        _, _, ap = _eval_class(dets_per_image, gts_per_image, ovthresh,
                               use_07_metric)
        aps[cls_name] = ap
        if not quiet:
            print("AP for {} = {:.4f}".format(cls_name, ap))
    mean_ap = float(np.mean(list(aps.values())))
    if not quiet:
        print("Mean AP = {:.4f}".format(mean_ap))
    return {"AP50": mean_ap, "per_class": aps}
