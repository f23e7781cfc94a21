#!/usr/bin/env python
"""Predictions beside the ground truth, drawn on each image (the JAX
package's tools_tpu/vis_pred.py; reference tools/vis_pred.py).

Reads a Pascal-format results.json (per class, per image: [x1, y1, x2,
y2, score] rows, as `cli.test` writes it) and the COCO-format ground
truth, and writes <out_dir>/<image>_pred.png and <image>_gt.png through
the port's Debugger (PNG files without cv2; the drawing uses cv2).

Usage:
  python tools_torch/vis_pred.py exp/ctdet/<exp_id>/results.json \\
      --gt data/voc/annotations/pascal_test2007.json \\
      --img_dir data/voc/images --out_dir vis/ [--thresh 0.3]
"""

import argparse
import json
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def main(argv=None):
    from codenet_torch.data.coco_io import CocoIndex
    from codenet_torch.engine.detector import imread
    from codenet_torch.utils.debugger import Debugger

    ap = argparse.ArgumentParser()
    ap.add_argument("results")
    ap.add_argument("--gt", required=True)
    ap.add_argument("--img_dir", required=True)
    ap.add_argument("--out_dir", default="vis")
    ap.add_argument("--thresh", type=float, default=0.3)
    ap.add_argument("--dataset", default="pascal")
    args = ap.parse_args(argv)

    with open(args.results) as f:
        dets = json.load(f)
    gt = CocoIndex(args.gt)
    img_ids = sorted(gt.getImgIds())
    os.makedirs(args.out_dir, exist_ok=True)

    dbg = Debugger(dataset=args.dataset)
    for i, img_id in enumerate(img_ids):
        info = gt.loadImgs(ids=[img_id])[0]
        try:
            img = imread(os.path.join(args.img_dir, info["file_name"]))
        except FileNotFoundError:
            continue
        dbg.add_img(img, img_id="pred")
        for cls in range(1, len(dets)):
            for box in dets[cls][i]:
                if box[4] > args.thresh:
                    dbg.add_coco_bbox(box[:4], cls - 1, box[4],
                                      img_id="pred")
        dbg.add_img(img, img_id="gt")
        for ann in gt.loadAnns(gt.getAnnIds(imgIds=[img_id])):
            x, y, w, h = ann["bbox"]
            dbg.add_coco_bbox([x, y, x + w, y + h],
                              ann["category_id"] - 1, 1.0, img_id="gt")
        dbg.save_all_imgs(args.out_dir,
                          prefix=os.path.splitext(info["file_name"])[0]
                          + "_")
    print("wrote visualizations to {}".format(args.out_dir))
    return 0


if __name__ == "__main__":
    sys.exit(main())
