#!/usr/bin/env python
"""COCO evaluation of a saved results.json (the JAX package's
tools_tpu/eval_coco.py; reference tools/eval_coco.py), through the port's
numpy COCOeval (codenet_torch/eval/coco_eval.py; no pycocotools).

Usage: python tools_torch/eval_coco.py results.json \\
           --gt data/coco/annotations/instances_val2017.json \\
           [--iou_type bbox|keypoints]
"""

import argparse
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("results")
    ap.add_argument("--gt", default="data/coco/annotations/instances_val2017.json")
    ap.add_argument("--iou_type", default="bbox",
                    choices=["bbox", "keypoints"])
    args = ap.parse_args(argv)

    from codenet_torch.data.coco_io import CocoIndex
    from codenet_torch.eval.coco_eval import CocoDetEval
    ev = CocoDetEval(CocoIndex(args.gt), args.results,
                     iou_type=args.iou_type)
    ev.evaluate()
    return ev.summarize()


if __name__ == "__main__":
    main()
