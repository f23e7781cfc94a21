#!/usr/bin/env python
"""KITTI label files and calibrations -> the COCO-format json the ddd
task reads (reference tools/convert_kitti_to_coco.py; the port's copy of
the JAX package's tool, which writes the same file): each image carries
its 3x4 P2 calibration, each annotation its alpha, depth, dimensions,
location, rotation_y, truncation and occlusion beside the 2D box.

  python tools_torch/convert_kitti_to_coco.py --kitti_dir data/kitti \\
      --split_file data/kitti/ImageSets/train.txt \\
      --out data/kitti/annotations/kitti_3dop_train.json
"""

import argparse
import json
import os

CAT_IDS = {"Pedestrian": 1, "Car": 2, "Cyclist": 3, "Van": 4,
           "Truck": 5, "Person_sitting": 6, "Tram": 7, "Misc": 8,
           "DontCare": 9}


def read_calib(path):
    """The P2 row of a KITTI calibration file as 3 rows of 4."""
    with open(path) as f:
        for line in f:
            if line.startswith("P2:"):
                vals = [float(v) for v in line.split()[1:]]
                return [vals[0:4], vals[4:8], vals[8:12]]
    raise ValueError("no P2 in {}".format(path))


def annotation(fields, ann_id, img_id):
    """One label line's fields as a COCO annotation."""
    x1, y1, x2, y2 = map(float, fields[4:8])
    return {"id": ann_id, "image_id": img_id,
            "category_id": CAT_IDS[fields[0]],
            "bbox": [x1, y1, x2 - x1, y2 - y1],
            "area": (x2 - x1) * (y2 - y1), "iscrowd": 0,
            "truncated": float(fields[1]),
            "occluded": int(float(fields[2])),
            "alpha": float(fields[3]),
            "dim": [float(fields[8]), float(fields[9]), float(fields[10])],
            "location": [float(fields[11]), float(fields[12]),
                         float(fields[13])],
            "depth": float(fields[13]), "rotation_y": float(fields[14])}


def convert(kitti_dir, ids, img_w=1242, img_h=375):
    """The COCO-format dict of the training frames `ids` (their file
    stems)."""
    images, annotations = [], []
    label_dir = os.path.join(kitti_dir, "training", "label_2")
    calib_dir = os.path.join(kitti_dir, "training", "calib")
    for sid in ids:
        img_id = int(sid)
        images.append({"id": img_id, "file_name": sid + ".png",
                       "width": img_w, "height": img_h,
                       "calib": read_calib(os.path.join(calib_dir,
                                                        sid + ".txt"))})
        with open(os.path.join(label_dir, sid + ".txt")) as f:
            for line in f:
                fields = line.strip().split(" ")
                if len(fields) < 15 or fields[0] not in CAT_IDS:
                    continue
                annotations.append(annotation(fields, len(annotations) + 1,
                                              img_id))
    return {"images": images, "annotations": annotations,
            "categories": [{"id": i, "name": n}
                           for n, i in CAT_IDS.items()]}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--kitti_dir", default="data/kitti")
    ap.add_argument("--split_file", required=True)
    ap.add_argument("--out", required=True)
    ap.add_argument("--img_w", type=int, default=1242)
    ap.add_argument("--img_h", type=int, default=375)
    args = ap.parse_args(argv)
    with open(args.split_file) as f:
        ids = [line.strip() for line in f if line.strip()]
    out = convert(args.kitti_dir, ids, args.img_w, args.img_h)
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(out, f)
    print("wrote {}: {} images, {} annotations".format(
        args.out, len(out["images"]), len(out["annotations"])))


if __name__ == "__main__":
    main()
