"""Minimal COCO-format JSON index.

Drop-in replacement for the pycocotools.coco.COCO subset the reference uses
(getImgIds/loadImgs/getAnnIds/loadAnns — lib/datasets/sample/ctdet.py:31-35);
this image has no pycocotools, and an index is ~40 lines of dict building.
"""

from __future__ import annotations

import json
from collections import defaultdict


class CocoIndex:
    def __init__(self, annotation_file):
        if isinstance(annotation_file, dict):
            self.dataset = annotation_file
        else:
            with open(annotation_file, "r") as f:
                self.dataset = json.load(f)
        self.imgs = {img["id"]: img for img in self.dataset.get("images", [])}
        self.anns = {ann["id"]: ann
                     for ann in self.dataset.get("annotations", [])}
        self.cats = {c["id"]: c for c in self.dataset.get("categories", [])}
        self.img_to_anns = defaultdict(list)
        for ann in self.dataset.get("annotations", []):
            self.img_to_anns[ann["image_id"]].append(ann["id"])

    def getImgIds(self):
        return list(self.imgs.keys())

    def loadImgs(self, ids):
        if not isinstance(ids, (list, tuple)):
            ids = [ids]
        return [self.imgs[i] for i in ids]

    def getAnnIds(self, imgIds):
        if not isinstance(imgIds, (list, tuple)):
            imgIds = [imgIds]
        out = []
        for i in imgIds:
            out.extend(self.img_to_anns[i])
        return out

    def loadAnns(self, ids):
        if not isinstance(ids, (list, tuple)):
            ids = [ids]
        return [self.anns[i] for i in ids]

    def getCatIds(self):
        return list(self.cats.keys())
