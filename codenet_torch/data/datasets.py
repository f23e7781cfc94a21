"""Dataset classes: metadata, annotation indexing, image reading, results
I/O, eval entry.

Reference lib/datasets/dataset/pascal.py on top of the self-contained
CocoIndex and the in-process VOC evaluator, composed with the ctdet
training sampler (data/samplers.py) as the reference's dataset factory
does. Only Pascal VOC with ctdet is ported so far (ROADMAP.md).
"""

from __future__ import annotations

import json
import os

import numpy as np

from ..engine.detector import imread
from .coco_io import CocoIndex
from .samplers import CTDetSampler


class BaseDataset:
    """Common loading logic shared by all datasets."""
    num_classes = None
    default_resolution = None
    mean = None
    std = None
    max_objs = 50

    # PCA lighting stats shared by all CenterNet datasets
    _eig_val = np.array([0.2141788, 0.01817699, 0.00341571], dtype=np.float32)
    _eig_vec = np.array([
        [-0.58752847, -0.69563484, 0.41340352],
        [-0.5832747, 0.00994535, -0.81221408],
        [-0.56089297, 0.71832671, 0.41158938]], dtype=np.float32)

    def __init__(self, opt, split):
        self.opt = opt
        self.split = split
        self._data_rng = np.random.RandomState(123)
        self.coco = CocoIndex(self.annot_path)
        self.images = self._image_ids()
        self.num_samples = len(self.images)
        print("Loaded {} {} samples".format(split, self.num_samples))

    def _image_ids(self):
        return self.coco.getImgIds()

    def __len__(self):
        return self.num_samples

    def load_image(self, index):
        """BGR uint8 (H, W, 3) pixels of image `index`: every reader of
        the dataset's images (sampler, eval) goes through here."""
        img_id = self.images[index]
        file_name = self.coco.loadImgs(ids=[img_id])[0]["file_name"]
        return imread(os.path.join(self.img_dir, file_name))


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
    """The dataset class for (dataset, task): the dataset's metadata with
    the task sampler mixed in (reference dataset_factory.py:31-34)."""
    if task != "ctdet" or dataset not in DATASET_FACTORY:
        raise NotImplementedError(
            "codenet_torch has ctdet on pascal so far; {} / {} is "
            "queued in ROADMAP.md".format(task, dataset))

    class Dataset(DATASET_FACTORY[dataset], CTDetSampler):
        pass
    return Dataset
