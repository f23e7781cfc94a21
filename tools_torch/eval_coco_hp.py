#!/usr/bin/env python
"""COCO keypoint evaluation of a saved results.json, then bbox on the
same file (the JAX package's tools_tpu/eval_coco_hp.py; reference
tools/eval_coco_hp.py), through the port's numpy COCOeval.

Usage: python tools_torch/eval_coco_hp.py results.json \\
           --gt data/coco/annotations/person_keypoints_val2017.json
"""

import argparse
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("results")
    ap.add_argument("--gt",
                    default="data/coco/annotations/"
                            "person_keypoints_val2017.json")
    args = ap.parse_args(argv)

    from codenet_torch.data.coco_io import CocoIndex
    from codenet_torch.eval.coco_eval import CocoDetEval

    gt = CocoIndex(args.gt)
    stats = {}
    for iou_type in ("keypoints", "bbox"):
        ev = CocoDetEval(gt, args.results, iou_type=iou_type)
        ev.evaluate()
        stats[iou_type] = ev.summarize()
    return stats


if __name__ == "__main__":
    main()
