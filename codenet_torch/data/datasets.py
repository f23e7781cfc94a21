"""Dataset classes: metadata, annotation indexing, results I/O, eval entry.

The evaluation half of reference lib/datasets/dataset/pascal.py on top of
the self-contained CocoIndex and the in-process VOC evaluator. Only Pascal
VOC is served so far; the training samplers come with the training path
(ROADMAP.md).
"""

from __future__ import annotations

import json
import os

import numpy as np

from .coco_io import CocoIndex


class BaseDataset:
    """Common loading logic shared by all datasets."""
    num_classes = None
    default_resolution = None
    mean = None
    std = None
    max_objs = 50

    def __init__(self, opt, split):
        self.opt = opt
        self.split = split
        self.coco = CocoIndex(self.annot_path)
        self.images = self._image_ids()
        self.num_samples = len(self.images)
        print("Loaded {} {} samples".format(split, self.num_samples))

    def _image_ids(self):
        return self.coco.getImgIds()

    def __len__(self):
        return self.num_samples


class PascalVOC(BaseDataset):
    """Pascal VOC in COCO-json form (reference dataset/pascal.py)."""
    num_classes = 20
    default_resolution = [384, 384]
    mean = np.array([0.485, 0.456, 0.406], np.float32).reshape(1, 1, 3)
    std = np.array([0.229, 0.224, 0.225], np.float32).reshape(1, 1, 3)
    max_objs = 50
    class_name = ["__background__", "aeroplane", "bicycle", "bird", "boat",
                  "bottle", "bus", "car", "cat", "chair", "cow",
                  "diningtable", "dog", "horse", "motorbike", "person",
                  "pottedplant", "sheep", "sofa", "train", "tvmonitor"]

    def __init__(self, opt, split):
        self.data_dir = os.path.join(opt.data_dir, "voc")
        self.img_dir = os.path.join(self.data_dir, "images")
        _ann_name = {"train": "trainval0712", "val": "test2007"}
        self.annot_path = os.path.join(
            self.data_dir, "annotations",
            "pascal_{}.json".format(_ann_name[split]))
        self._valid_ids = np.arange(1, 21, dtype=np.int32)
        self.cat_ids = {v: i for i, v in enumerate(self._valid_ids)}
        super().__init__(opt, split)

    def _image_ids(self):
        return sorted(self.coco.getImgIds())

    def convert_eval_format(self, all_bboxes):
        """Per-class list-of-lists results.json (reference pascal.py:58-68)."""
        detections = [[[] for _ in range(self.num_samples)]
                      for _ in range(self.num_classes + 1)]
        for i in range(self.num_samples):
            img_id = self.images[i]
            for j in range(1, self.num_classes + 1):
                if isinstance(all_bboxes[img_id][j], np.ndarray):
                    detections[j][i] = all_bboxes[img_id][j].tolist()
                else:
                    detections[j][i] = all_bboxes[img_id][j]
        return detections

    def save_results(self, results, save_dir):
        with open("{}/results.json".format(save_dir), "w") as f:
            json.dump(self.convert_eval_format(results), f)

    def run_eval(self, results, save_dir):
        """In-process VOC AP50 (reference shells to tools/reval.py)."""
        self.save_results(results, save_dir)
        from ..eval.voc_eval import voc_eval_from_coco_json
        return voc_eval_from_coco_json(
            "{}/results.json".format(save_dir), self.annot_path,
            class_names=self.class_name[1:], use_07_metric=True)


DATASET_FACTORY = {
    "pascal": PascalVOC,
}


def get_dataset(dataset, task):
    """The eval dataset class for (dataset, task) (reference
    dataset_factory.py:31-34, without the training sampler mixin)."""
    if task != "ctdet" or dataset not in DATASET_FACTORY:
        raise NotImplementedError(
            "codenet_torch serves ctdet on pascal so far; {} / {} is "
            "queued in ROADMAP.md".format(task, dataset))
    return DATASET_FACTORY[dataset]
