#!/usr/bin/env python
"""Re-score a saved Pascal VOC results.json (the JAX package's
tools_tpu/reval.py; reference tools/reval.py).

In-process VOC AP against the COCO-format VOC ground truth through the
port's evaluator (codenet_torch/eval/voc_eval.py: the reference's boxes
and 11-point AP).

Usage: python tools_torch/reval.py results.json \\
           --gt data/voc/annotations/pascal_test2007.json [--use_12_metric]
"""

import argparse
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

VOC_CLASSES = ["aeroplane", "bicycle", "bird", "boat", "bottle", "bus",
               "car", "cat", "chair", "cow", "diningtable", "dog", "horse",
               "motorbike", "person", "pottedplant", "sheep", "sofa",
               "train", "tvmonitor"]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("detection_file")
    ap.add_argument("--gt", default="data/voc/annotations/pascal_test2007.json")
    ap.add_argument("--ovthresh", type=float, default=0.5)
    ap.add_argument("--use_12_metric", action="store_true",
                    help="area-under-curve AP instead of VOC07 11-point")
    args = ap.parse_args(argv)

    from codenet_torch.eval.voc_eval import voc_eval_from_coco_json
    return voc_eval_from_coco_json(
        args.detection_file, args.gt, VOC_CLASSES,
        ovthresh=args.ovthresh, use_07_metric=not args.use_12_metric)


if __name__ == "__main__":
    main()
