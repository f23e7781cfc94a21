#!/usr/bin/env python
"""Upper-bound recall: anchor grids against centre-point assignment.

For a COCO-format annotation file, the best recall reachable at given IoU
thresholds (a) by shape-only anchor assignment over two standard anchor
sets and (b) by CenterNet's centre-keypoint assignment at an output
stride, where an object is recoverable unless a larger object of its
class claims its quantized centre cell (reference
tools/calc_coco_overlap.py). The port's copy of the JAX package's tool,
on the port's COCO index (codenet_torch/data/coco_io.py); it prints the
same table:

  python tools_torch/calc_coverage.py DATA/voc/annotations/pascal_test2007.json \\
      [--input_res 512] [--down_ratio 4] [--iou 0.5 0.7]
"""

import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def iou_wh(wh_a, wh_b):
    """IoU of boxes centred on one point, from their (w, h) pairs."""
    inter = np.minimum(wh_a[:, None, 0], wh_b[None, :, 0]) * \
        np.minimum(wh_a[:, None, 1], wh_b[None, :, 1])
    union = (wh_a[:, 0] * wh_a[:, 1])[:, None] + \
        (wh_b[:, 0] * wh_b[:, 1])[None, :] - inter
    return inter / np.maximum(union, 1e-9)


def anchor_recall(whs, anchors, thresh):
    """Share of objects whose best anchor (shape only) reaches `thresh`."""
    ious = iou_wh(whs, anchors)
    return float((ious.max(axis=1) >= thresh).mean())


def center_recall(boxes_per_image, input_res, down_ratio):
    """Share of objects whose quantized centre cell no larger object of
    the same class claims first (CenterNet's collisions)."""
    total = 0
    recoverable = 0
    out = input_res // down_ratio
    for boxes in boxes_per_image:
        cells = {}
        order = np.argsort(-(boxes[:, 2] * boxes[:, 3]))  # large first
        for i in order:
            x, y, w, h, cls = boxes[i]
            cx = int(np.clip((x + w / 2) / input_res * out, 0, out - 1))
            cy = int(np.clip((y + h / 2) / input_res * out, 0, out - 1))
            key = (int(cls), cy, cx)
            total += 1
            if key not in cells:
                cells[key] = i
                recoverable += 1
    return recoverable / max(total, 1)


def main(argv=None):
    from codenet_torch.data.coco_io import CocoIndex

    ap = argparse.ArgumentParser()
    ap.add_argument("annotations")
    ap.add_argument("--input_res", type=int, default=512)
    ap.add_argument("--down_ratio", type=int, default=4)
    ap.add_argument("--iou", type=float, nargs="+", default=[0.5, 0.7])
    args = ap.parse_args(argv)

    gt = CocoIndex(args.annotations)
    whs = []
    boxes_per_image = []
    for img_id in gt.getImgIds():
        info = gt.loadImgs(ids=[img_id])[0]
        scale = args.input_res / max(info.get("width", args.input_res),
                                     info.get("height", args.input_res))
        rows = []
        for ann in gt.loadAnns(gt.getAnnIds(imgIds=[img_id])):
            x, y, w, h = ann["bbox"]
            whs.append([w * scale, h * scale])
            rows.append([x * scale, y * scale, w * scale, h * scale,
                         ann["category_id"]])
        if rows:
            boxes_per_image.append(np.array(rows, np.float32))
    whs = np.array(whs, np.float32)
    print(f"{len(whs)} objects over {len(boxes_per_image)} images "
          f"(scaled to {args.input_res})")

    # anchor sets: scales x ratios on strides 8/16/32, and nine sizes
    ratios = [0.5, 1.0, 2.0]
    anchor_sets = {
        "retina-9 (3 scales x 3 ratios / level)": [
            (s * 4 * 2 ** (k / 3), r)
            for s in (8, 16, 32) for k in range(3) for r in ratios],
        "yolo-9 (k-means-ish)": [(a, 1.0) for a in
                                 (10, 30, 60, 100, 160, 220, 280, 340, 400)],
    }
    for name, spec in anchor_sets.items():
        anchors = np.array([[b * np.sqrt(r), b / np.sqrt(r)]
                            for b, r in spec], np.float32)
        for t in args.iou:
            print(f"  {name}: recall@IoU{t} = "
                  f"{anchor_recall(whs, anchors, t):.4f}")
    cr = center_recall(boxes_per_image, args.input_res, args.down_ratio)
    print(f"  center-point (stride {args.down_ratio}): "
          f"collision-free recall = {cr:.4f}")


if __name__ == "__main__":
    main()
