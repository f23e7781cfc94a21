"""Dataset classes: metadata, annotation indexing, image reading, results
I/O, eval entry.

Reference lib/datasets/dataset/{pascal,coco,kitti,coco_hp}.py on top of
the self-contained CocoIndex and the in-process VOC, COCO and KITTI
evaluators (eval/), composed with the task's training sampler
(data/samplers.py) as the reference's dataset factory does: ctdet on
pascal or coco, ddd on kitti, multi_pose on coco_hp, exdet on coco (its
instances_extreme_*.json). Any other pairing raises.
"""

from __future__ import annotations

import json
import os

import numpy as np

from ..engine.detector import imread
from .coco_io import CocoIndex
from .samplers import (CTDetSampler, DddSampler, ExdetSampler,
                       MultiPoseSampler)


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

    def save_results(self, results, save_dir):
        """results.json in the dataset's eval format."""
        with open("{}/results.json".format(save_dir), "w") as f:
            json.dump(self.convert_eval_format(results), f)

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

    def run_eval(self, results, save_dir):
        """In-process VOC AP50 (reference shells to tools/reval.py)."""
        self.save_results(results, save_dir)
        from ..eval.voc_eval import voc_eval_from_coco_json
        return voc_eval_from_coco_json(
            "{}/results.json".format(save_dir), self.annot_path,
            class_names=self.class_name[1:], use_07_metric=True)


class COCO(BaseDataset):
    """COCO 2017 (reference dataset/coco.py)."""
    num_classes = 80
    default_resolution = [512, 512]
    mean = np.array([0.40789654, 0.44719302, 0.47026115],
                    np.float32).reshape(1, 1, 3)
    std = np.array([0.28863828, 0.27408164, 0.27809835],
                   np.float32).reshape(1, 1, 3)
    max_objs = 128
    iou_type = "bbox"
    _valid_ids = [
        1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 13,
        14, 15, 16, 17, 18, 19, 20, 21, 22, 23,
        24, 25, 27, 28, 31, 32, 33, 34, 35, 36,
        37, 38, 39, 40, 41, 42, 43, 44, 46, 47,
        48, 49, 50, 51, 52, 53, 54, 55, 56, 57,
        58, 59, 60, 61, 62, 63, 64, 65, 67, 70,
        72, 73, 74, 75, 76, 77, 78, 79, 80, 81,
        82, 84, 85, 86, 87, 88, 89, 90]

    def __init__(self, opt, split):
        self.data_dir = os.path.join(opt.data_dir, "coco")
        self.img_dir = os.path.join(self.data_dir, "{}2017".format(split))
        if split == "test":
            self.annot_path = os.path.join(
                self.data_dir, "annotations",
                "image_info_test-dev2017.json")
        elif getattr(opt, "task", "") == "exdet":
            self.annot_path = os.path.join(
                self.data_dir, "annotations",
                "instances_extreme_{}2017.json".format(split))
        else:
            self.annot_path = os.path.join(
                self.data_dir, "annotations",
                "instances_{}2017.json".format(split))
        self.cat_ids = {v: i for i, v in enumerate(self._valid_ids)}
        super().__init__(opt, split)

    @staticmethod
    def _to_float(x):
        return float("{:.2f}".format(x))

    def convert_eval_format(self, all_bboxes):
        """COCO detection dicts, 2-decimal rounding (reference
        coco.py:90-112)."""
        detections = []
        for image_id in all_bboxes:
            for cls_ind in all_bboxes[image_id]:
                category_id = self._valid_ids[cls_ind - 1]
                for bbox in all_bboxes[image_id][cls_ind]:
                    bbox = list(bbox)
                    bbox[2] -= bbox[0]
                    bbox[3] -= bbox[1]
                    detection = {
                        "image_id": int(image_id),
                        "category_id": int(category_id),
                        "bbox": list(map(self._to_float, bbox[0:4])),
                        "score": float("{:.2f}".format(bbox[4])),
                    }
                    if len(bbox) > 5:
                        detection["extreme_points"] = list(
                            map(self._to_float, bbox[5:13]))
                    detections.append(detection)
        return detections

    def run_eval(self, results, save_dir):
        """COCO AP (`iou_type`: 12 bbox stats, or 10 keypoint stats),
        printed and returned."""
        self.save_results(results, save_dir)
        from ..eval.coco_eval import CocoDetEval
        ev = CocoDetEval(self.coco, "{}/results.json".format(save_dir),
                         iou_type=self.iou_type)
        ev.evaluate()
        return ev.summarize()


class KITTI(BaseDataset):
    """KITTI 3D object detection (reference dataset/kitti.py): COCO-format
    annotations with per-image `calib` and per-object alpha, depth and
    dim, and the KITTI label txts under training/label_2 for the scorer."""
    num_classes = 3
    default_resolution = [384, 1280]
    mean = np.array([0.485, 0.456, 0.406], np.float32).reshape(1, 1, 3)
    std = np.array([0.229, 0.224, 0.225], np.float32).reshape(1, 1, 3)
    max_objs = 50
    class_name = ["__background__", "Pedestrian", "Car", "Cyclist"]
    # Van and Truck ignore-map onto Car (-3), Person_sitting onto
    # Pedestrian (-2), DontCare onto every class (-1); -99 is skipped
    cat_ids = {1: 0, 2: 1, 3: 2, 4: -3, 5: -3, 6: -2, 7: -99, 8: -99, 9: -1}

    def __init__(self, opt, split):
        self.data_dir = os.path.join(opt.data_dir, "kitti")
        self.img_dir = os.path.join(self.data_dir, "images", "trainval")
        self.annot_path = os.path.join(
            self.data_dir, "annotations",
            "kitti_{}_{}.json".format(opt.kitti_split, split))
        self.alpha_in_degree = False
        super().__init__(opt, split)

    def save_results(self, results, save_dir):
        """One KITTI label txt per image, `{:06d}.txt`, under
        save_dir/results: `<class> 0.0 0` then the row's values at two
        decimals (alpha, box, dim, location, rotation_y, score)."""
        results_dir = os.path.join(save_dir, "results")
        os.makedirs(results_dir, exist_ok=True)
        for img_id in results:
            out_path = os.path.join(results_dir, "{:06d}.txt".format(img_id))
            with open(out_path, "w") as f:
                for cls_ind in results[img_id]:
                    for j in range(len(results[img_id][cls_ind])):
                        class_name = self.class_name[cls_ind]
                        f.write("{} 0.0 0".format(class_name))
                        for i in range(len(results[img_id][cls_ind][j])):
                            f.write(" {:.2f}".format(
                                results[img_id][cls_ind][j][i]))
                        f.write("\n")

    def run_eval(self, results, save_dir):
        """The KITTI AP table (class x difficulty; AP2D, AOS, BEV, 3D),
        printed and returned, from the port's host C++ scorer."""
        self.save_results(results, save_dir)
        from ..eval.kitti_eval import kitti_eval
        return kitti_eval(os.path.join(save_dir, "results"),
                          os.path.join(self.data_dir, "training", "label_2"))


class COCOHP(COCO):
    """COCO person keypoints (reference dataset/coco_hp.py): COCO's
    frames, normalisation and evaluator, scored by keypoint OKS."""
    num_classes = 1
    num_joints = 17
    max_objs = 32
    iou_type = "keypoints"
    flip_idx = [[1, 2], [3, 4], [5, 6], [7, 8], [9, 10], [11, 12],
                [13, 14], [15, 16]]
    _valid_ids = [1]

    def __init__(self, opt, split):
        self.data_dir = os.path.join(opt.data_dir, "coco")
        self.img_dir = os.path.join(self.data_dir, "{}2017".format(split))
        self.annot_path = os.path.join(
            self.data_dir, "annotations",
            "person_keypoints_{}2017.json".format(split))
        self.cat_ids = {1: 0}
        BaseDataset.__init__(self, opt, split)

    def convert_eval_format(self, all_bboxes):
        """COCO keypoint dicts: the box rounded to 2 decimals, the 17
        joints with visibility 1 (reference coco_hp.py:90-120)."""
        detections = []
        for image_id in all_bboxes:
            for cls_ind in all_bboxes[image_id]:
                for dets in all_bboxes[image_id][cls_ind]:
                    bbox = [dets[0], dets[1], dets[2] - dets[0],
                            dets[3] - dets[1]]
                    kps = np.concatenate([
                        np.array(dets[5:39], np.float32).reshape(-1, 2),
                        np.ones((17, 1), np.float32)], axis=1).reshape(
                        51).tolist()
                    detections.append({
                        "image_id": int(image_id),
                        "category_id": 1,
                        "bbox": list(map(self._to_float, bbox)),
                        "score": float("{:.2f}".format(dets[4])),
                        "keypoints": kps,
                    })
        return detections


DATASET_FACTORY = {
    "coco": COCO,
    "pascal": PascalVOC,
    "kitti": KITTI,
    "coco_hp": COCOHP,
}

# the datasets each task's sampler serves (reference dataset_factory.py)
SAMPLE_FACTORY = {
    "ctdet": (CTDetSampler, ("pascal", "coco")),
    "ddd": (DddSampler, ("kitti",)),
    "multi_pose": (MultiPoseSampler, ("coco_hp",)),
    "exdet": (ExdetSampler, ("coco",)),
}


def get_dataset(dataset, task):
    """The dataset class for (dataset, task): the dataset's metadata with
    the task sampler mixed in (reference dataset_factory.py:31-34)."""
    sampler, datasets = SAMPLE_FACTORY.get(task, (None, ()))
    if dataset not in datasets:
        raise NotImplementedError(
            "codenet_torch serves ctdet on pascal and coco, ddd on kitti, "
            "multi_pose on coco_hp and exdet on coco; not {} on {}"
            .format(task, dataset))

    class Dataset(DATASET_FACTORY[dataset], sampler):
        pass
    return Dataset
