"""Visual debugging (the JAX package's utils/debugger.py; reference
lib/utils/debugger.py).

A registry of named images: heatmap colour maps blended over inputs, box
and keypoint overlays, 3D boxes and a bird's-eye view for ddd, saved as
PNG files (data/image_io.py::write_png) or shown in cv2 windows. It
drives --debug 1..4 (reference lib/opts.py:19-24), the demo CLI and
tools_torch/vis_pred.py. It draws with cv2, imported when a Debugger is
made, so that importing the package never needs it. Heatmaps are (H, W,
C), channel last, as the port's heads are.
"""

from __future__ import annotations

import os

import numpy as np

from ..data.image_io import write_png

PASCAL_CLASS_NAME = [
    "aeroplane", "bicycle", "bird", "boat", "bottle", "bus", "car", "cat",
    "chair", "cow", "diningtable", "dog", "horse", "motorbike", "person",
    "pottedplant", "sheep", "sofa", "train", "tvmonitor"]

COCO_CLASS_NAME = [
    "person", "bicycle", "car", "motorcycle", "airplane", "bus", "train",
    "truck", "boat", "traffic light", "fire hydrant", "stop sign",
    "parking meter", "bench", "bird", "cat", "dog", "horse", "sheep", "cow",
    "elephant", "bear", "zebra", "giraffe", "backpack", "umbrella",
    "handbag", "tie", "suitcase", "frisbee", "skis", "snowboard",
    "sports ball", "kite", "baseball bat", "baseball glove", "skateboard",
    "surfboard", "tennis racket", "bottle", "wine glass", "cup", "fork",
    "knife", "spoon", "bowl", "banana", "apple", "sandwich", "orange",
    "broccoli", "carrot", "hot dog", "pizza", "donut", "cake", "chair",
    "couch", "potted plant", "bed", "dining table", "toilet", "tv",
    "laptop", "mouse", "remote", "keyboard", "cell phone", "microwave",
    "oven", "toaster", "sink", "refrigerator", "book", "clock", "vase",
    "scissors", "teddy bear", "hair drier", "toothbrush"]

KITTI_CLASS_NAME = ["p", "v", "b"]

# COCO keypoint skeleton edges (pairs of joint ids)
_KP_EDGES = [[0, 1], [0, 2], [1, 3], [2, 4], [3, 5], [4, 6], [5, 6],
             [5, 7], [7, 9], [6, 8], [8, 10], [5, 11], [6, 12], [11, 12],
             [11, 13], [13, 15], [12, 14], [14, 16]]


class Debugger:
    """The class colours are 200 draws of numpy's global generator, as in
    the reference: seed it (np.random.seed) for repeatable renders."""

    def __init__(self, ipynb=False, theme="white", num_classes=-1,
                 dataset=None, down_ratio=4):
        import cv2
        self.cv2 = cv2
        self.ipynb = ipynb
        self.theme = theme
        self.imgs = {}
        self.down_ratio = down_ratio

        colors = [((np.random.random((3,)) * 0.6 + 0.4) * 255).astype(
            np.uint8) for _ in range(200)]
        self.colors = np.array(colors, dtype=np.uint8).reshape(200, 1, 1, 3)
        if self.theme == "white":
            self.colors = self.colors.reshape(-1)[::-1].reshape(200, 1, 1, 3)
            self.colors = np.clip(self.colors, 0.0, 0.6 * 255).astype(
                np.uint8)

        if dataset == "pascal":
            self.names = PASCAL_CLASS_NAME
        elif dataset in ("coco", "coco_hp"):
            self.names = COCO_CLASS_NAME
        elif dataset in ("kitti", "gta", "viper"):
            self.names = KITTI_CLASS_NAME
        else:
            self.names = [str(i) for i in range(max(num_classes, 1))]
        self.num_classes = len(self.names)

    # -- registry ----------------------------------------------------------
    def add_img(self, img, img_id="default", revert_color=False):
        if revert_color:
            img = 255 - img
        self.imgs[img_id] = img.copy()

    def add_mask(self, mask, bg, img_id="default", trans=0.8):
        self.imgs[img_id] = (mask.reshape(
            mask.shape[0], mask.shape[1], 1) * 255 * trans
            + bg * (1 - trans)).astype(np.uint8)

    def add_blend_img(self, back, fore, img_id="blend", trans=0.7):
        if self.theme == "white":
            fore = 255 - fore
        if fore.shape[0] != back.shape[0] or fore.shape[1] != back.shape[1]:
            fore = self.cv2.resize(fore, (back.shape[1], back.shape[0]))
        if len(fore.shape) == 2:
            fore = fore.reshape(fore.shape[0], fore.shape[1], 1)
        self.imgs[img_id] = (back * (1.0 - trans) + fore * trans)
        self.imgs[img_id][self.imgs[img_id] > 255] = 255
        self.imgs[img_id][self.imgs[img_id] < 0] = 0
        self.imgs[img_id] = self.imgs[img_id].astype(np.uint8).copy()

    # -- heatmaps ----------------------------------------------------------
    def gen_colormap(self, img, output_res=None):
        """(H, W, C) heatmap -> colour image, each class in its colour, at
        `output_res` (h, w), by default the input's (down_ratio x)."""
        img = img.copy()
        h, w, c = img.shape
        if output_res is None:
            output_res = (h * self.down_ratio, w * self.down_ratio)
        img = img.transpose(2, 0, 1).reshape(c, h, w, 1).astype(np.float32)
        colors = np.array(self.colors[:c], dtype=np.float32).reshape(
            c, 1, 1, 3)
        if self.theme == "white":
            colors = 255 - colors
        color_map = (img * colors).max(axis=0).astype(np.uint8)
        return self.cv2.resize(color_map, (output_res[1], output_res[0]))

    gen_colormap_hp = gen_colormap

    # -- overlays ----------------------------------------------------------
    def add_coco_bbox(self, bbox, cat, conf=1, show_txt=True,
                      img_id="default"):
        cv2 = self.cv2
        bbox = np.array(bbox, dtype=np.int32)
        cat = int(cat)
        c = self.colors[cat][0][0].tolist()
        if self.theme == "white":
            c = (255 - np.array(c)).tolist()
        txt = "{}{:.1f}".format(self.names[cat], conf)
        font = cv2.FONT_HERSHEY_SIMPLEX
        cat_size = cv2.getTextSize(txt, font, 0.5, 2)[0]
        cv2.rectangle(self.imgs[img_id], (bbox[0], bbox[1]),
                      (bbox[2], bbox[3]), c, 2)
        if show_txt:
            cv2.rectangle(self.imgs[img_id],
                          (bbox[0], bbox[1] - cat_size[1] - 2),
                          (bbox[0] + cat_size[0], bbox[1] - 2), c, -1)
            cv2.putText(self.imgs[img_id], txt,
                        (bbox[0], bbox[1] - 2), font, 0.5,
                        (0, 0, 0), thickness=1, lineType=cv2.LINE_AA)

    def add_coco_hp(self, points, img_id="default"):
        cv2 = self.cv2
        points = np.array(points, dtype=np.int32).reshape(17, 2)
        for j in range(17):
            cv2.circle(self.imgs[img_id], (points[j, 0], points[j, 1]), 3,
                       (255, 0, 255), -1)
        for e in _KP_EDGES:
            if points[e].min() > 0:
                cv2.line(self.imgs[img_id],
                         (points[e[0], 0], points[e[0], 1]),
                         (points[e[1], 0], points[e[1], 1]),
                         (255, 0, 0), 2, lineType=cv2.LINE_AA)

    def add_ct_detection(self, img, dets, show_box=False, show_txt=True,
                         center_thresh=0.5, img_id="det"):
        self.imgs[img_id] = img.copy()
        for i in range(len(dets)):
            if dets[i, 2] > center_thresh:
                cl = (self.colors[int(dets[i, -1])][0][0]).tolist()
                ct = dets[i, :2].astype(np.int32) * self.down_ratio
                self.cv2.circle(self.imgs[img_id], tuple(ct), 3, cl, -1)

    def add_3d_detection(self, image_or_path, dets, calib,
                         show_txt=False, center_thresh=0.5, img_id="det"):
        """ddd detections {class: (n, 14+) rows} as 3D wireframes over an
        image or the image file at a path (read as engine/detector.py's
        `imread` reads it: PNG without cv2)."""
        from .ddd_utils import compute_box_3d, draw_box_3d, project_to_image
        if isinstance(image_or_path, np.ndarray):
            self.imgs[img_id] = image_or_path.copy()
        else:
            from ..engine.detector import imread
            self.imgs[img_id] = imread(image_or_path)
        for cat in dets:
            cl = (self.colors[cat - 1, 0, 0]).tolist()
            for i in range(len(dets[cat])):
                if dets[cat][i, -1] > center_thresh:
                    dim = dets[cat][i, 5:8]
                    loc = dets[cat][i, 8:11]
                    rot_y = dets[cat][i, 11]
                    if loc[2] > 1:
                        box_3d = compute_box_3d(dim, loc, rot_y)
                        box_2d = project_to_image(box_3d, calib).astype(
                            np.int32)
                        self.imgs[img_id] = draw_box_3d(
                            self.imgs[img_id], box_2d, cl)

    def add_bird_view(self, dets, center_thresh=0.3, img_id="bird",
                      world_size=64, out_size=384):
        bird_view = np.ones((out_size, out_size, 3), dtype=np.uint8) * 230
        for cat in dets:
            cl = (255 - self.colors[cat - 1, 0, 0]).tolist()
            for i in range(len(dets[cat])):
                if dets[cat][i, -1] > center_thresh:
                    dim = dets[cat][i, 5:8]
                    loc = dets[cat][i, 8:11]
                    rot_y = dets[cat][i, 11]
                    # every corner to int pixels before the first line:
                    # the JAX Debugger converts each corner as it draws
                    # from it, so its first line ends at a float corner,
                    # which cv2 refuses
                    rect = [(int(x), int(z)) for x, z in _compute_bird_rect(
                        dim, loc, rot_y, world_size, out_size)]
                    for k in range(4):
                        self.cv2.line(bird_view, rect[k], rect[(k + 1) % 4],
                                      cl, 1, lineType=self.cv2.LINE_AA)
        self.imgs[img_id] = bird_view

    # -- output ------------------------------------------------------------
    def save_all_imgs(self, path="./cache/debug/", prefix="", genID=False):
        """Every image as <path>/<prefix><name>.png (a grey one as three
        equal channels)."""
        os.makedirs(path, exist_ok=True)
        for i, v in self.imgs.items():
            if v.ndim == 2:
                v = np.repeat(v[..., None], 3, axis=2)
            write_png(os.path.join(path, "{}{}.png".format(prefix, i)), v)

    def show_all_imgs(self, pause=False, time_=0):
        for i, v in self.imgs.items():
            self.cv2.imshow("{}".format(i), v)
        if self.cv2.waitKey(0 if pause else 1) == 27:
            import sys
            sys.exit(0)


def _compute_bird_rect(dim, location, rotation_y, world_size, out_size):
    """Footprint rectangle of a 3D box in bird's-eye-view pixels."""
    c, s = np.cos(rotation_y), np.sin(rotation_y)
    R = np.array([[c, s], [-s, c]], dtype=np.float32)
    l, w = dim[2], dim[1]
    x_corners = np.array([l / 2, l / 2, -l / 2, -l / 2], np.float32)
    z_corners = np.array([w / 2, -w / 2, -w / 2, w / 2], np.float32)
    corners = R @ np.stack([x_corners, z_corners])
    corners = corners + np.array([[location[0]], [location[2]]], np.float32)
    pts = []
    for k in range(4):
        x = (corners[0, k] + world_size / 2) * out_size / world_size
        z = out_size - corners[1, k] * out_size / world_size
        pts.append([x, z])
    return pts
