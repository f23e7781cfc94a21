#!/usr/bin/env python
"""Merge COCO-format VOC annotation files (VOC2007 + VOC2012 trainval)
into one, pascal_trainval0712.json (reference
tools/merge_pascal_json.py; the port's copy of the JAX package's tool,
which writes the same file): the first file's categories, every image and
annotation of each file with its ids shifted past the files before it.

  python tools_torch/merge_pascal_json.py pascal_trainval2007.json \\
      pascal_trainval2012.json --out pascal_trainval0712.json
"""

import argparse
import json


def merge(dbs):
    """One COCO-format dict of the parsed files `dbs`, in order."""
    out = {"images": [], "annotations": [], "categories": None}
    img_offset = ann_offset = 0
    for db in dbs:
        if out["categories"] is None:
            out["categories"] = db["categories"]
        ids = {}
        for img in db["images"]:
            ids[img["id"]] = img["id"] + img_offset
            out["images"].append(dict(img, id=ids[img["id"]]))
        for ann in db["annotations"]:
            out["annotations"].append(dict(
                ann, id=ann["id"] + ann_offset,
                image_id=ids[ann["image_id"]]))
        img_offset = max((i["id"] for i in out["images"]), default=0) + 1
        ann_offset = max((a["id"] for a in out["annotations"]),
                         default=0) + 1
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("inputs", nargs="+")
    ap.add_argument("--out", required=True)
    args = ap.parse_args(argv)
    dbs = []
    for path in args.inputs:
        with open(path) as f:
            dbs.append(json.load(f))
    out = merge(dbs)
    with open(args.out, "w") as f:
        json.dump(out, f)
    print("wrote {}: {} images, {} annotations".format(
        args.out, len(out["images"]), len(out["annotations"])))


if __name__ == "__main__":
    main()
