"""Synthetic VOC-format dataset on PNG files: coloured rectangles on noise.

The port's own copy of the JAX package's tests/synthetic.py generator:
the same numpy RandomState draws in the same order, so the boxes,
classes and pixels are that generator's, written as ``{id:06d}.png``
through codenet_torch/data/image_io.py (no cv2 needed), or as that
generator's JPEG files (``frames="jpg"``, through cv2). Class identity
is encoded in the fill colour (or, with ``adversarial``, in a
class-keyed texture), so a detector can generalise to held-out images:
`make_voc_dataset(..., test_images=N)` writes a test2007 split of fresh
images from seed + 1.
"""

import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
from codenet_torch.data.image_io import write_png  # noqa: E402

VOC_CLASSES = ["aeroplane", "bicycle", "bird", "boat", "bottle", "bus",
               "car", "cat", "chair", "cow", "diningtable", "dog", "horse",
               "motorbike", "person", "pottedplant", "sheep", "sofa",
               "train", "tvmonitor"]


def _class_color(cls):
    return [int(60 + cls * 9) % 255, 200, (cls * 37) % 255]


def _class_texture(cls, h, w, rng):
    """Textured class appearance (adversarial mode): two class-derived
    colours in stripes whose period (3 + cls % 4) and orientation
    (cls % 3: horizontal / vertical / diagonal) are class-keyed, plus
    per-instance pixel noise."""
    c1 = np.array(_class_color(cls), np.float32)
    c2 = np.array(_class_color((cls * 7 + 3) % 20), np.float32) * 0.5 + 40
    period = 3 + cls % 4
    yy, xx = np.mgrid[0:h, 0:w]
    phase = (yy, xx, yy + xx)[cls % 3]
    stripe = ((phase // period) % 2).astype(np.float32)[..., None]
    tex = c1 * stripe + c2 * (1.0 - stripe)
    tex = tex + rng.randn(h, w, 3) * 10.0
    return np.clip(tex, 0, 255).astype(np.uint8)


def _iou(a, b):
    ax1, ay1, aw, ah = a
    bx1, by1, bw, bh = b
    ix = max(0, min(ax1 + aw, bx1 + bw) - max(ax1, bx1))
    iy = max(0, min(ay1 + ah, by1 + bh) - max(ay1, by1))
    inter = ix * iy
    return inter / float(aw * ah + bw * bh - inter + 1e-9)


def _gen_images(rng, num_images, img_w, img_h, first_id, max_objects=3,
                num_classes=20, min_side=16, adversarial=False):
    """Deterministic images + annotations; boxes never exceed half the
    image, sides span [min_side, dim/2].

    adversarial=True: class-keyed texture instead of flat colour, objects
    down to 8 px, overlap allowed up to IoU 0.5 (later objects occlude
    earlier ones), and untextured grey distractor rectangles in the
    background. Returns (images, annotations, [(file name, BGR pixels)])."""
    images, annotations, pixels = [], [], []
    ann_id = first_id * 1000 + 1
    lo_side = 8 if adversarial else min_side
    for i in range(num_images):
        img_id = first_id + i
        img = (rng.rand(img_h, img_w, 3) * 60).astype(np.uint8)
        if adversarial:
            for _ in range(rng.randint(1, 4)):  # grey distractors
                dw = rng.randint(8, img_w // 3)
                dh = rng.randint(8, img_h // 3)
                dx = rng.randint(0, img_w - dw)
                dy = rng.randint(0, img_h - dh)
                g = rng.randint(60, 200)
                img[dy:dy + dh, dx:dx + dw] = (g, g, g)
        n_obj = rng.randint(1, max_objects + 1)
        placed = []
        for _ in range(n_obj):
            for _attempt in range(8):
                w = rng.randint(lo_side, img_w // 2)
                h = rng.randint(lo_side, img_h // 2)
                x = rng.randint(0, img_w - w)
                y = rng.randint(0, img_h - h)
                box = (x, y, w, h)
                if not adversarial:
                    break
                if all(_iou(box, p) <= 0.5 for p in placed):
                    break
            else:
                continue
            placed.append(box)
            cls = int(rng.randint(0, num_classes))
            if adversarial:
                img[y:y + h, x:x + w] = _class_texture(cls, h, w, rng)
            else:
                img[y:y + h, x:x + w] = _class_color(cls)
            annotations.append({
                "id": ann_id, "image_id": img_id, "category_id": cls + 1,
                "bbox": [float(x), float(y), float(w), float(h)],
                "area": float(w * h), "iscrowd": 0, "difficult": 0,
            })
            ann_id += 1
        fname = "{:06d}.png".format(img_id)
        images.append({"id": img_id, "file_name": fname,
                       "width": img_w, "height": img_h})
        pixels.append((fname, img))
    return images, annotations, pixels


def make_voc_dataset(root, num_images=4, img_w=128, img_h=96, seed=0,
                     test_images=None, max_objects=3, num_classes=20,
                     min_side=16, adversarial=False, frames="png"):
    """Write <root>/voc/{images,annotations}/ with deterministic boxes.

    test_images=None: test2007 == trainval0712 (an overfit fixture).
    test_images=N: a held-out test split of N fresh images from seed + 1,
    the same distribution with disjoint content. frames="jpg" writes the
    frames as tests/synthetic.py does, JPEG through cv2.imwrite (needs
    cv2), so that the set is that generator's file for file. Returns
    <root>/voc.
    """
    if frames not in ("png", "jpg"):
        raise ValueError("frames is png or jpg, not {!r}".format(frames))
    rng = np.random.RandomState(seed)
    img_dir = os.path.join(root, "voc", "images")
    ann_dir = os.path.join(root, "voc", "annotations")
    os.makedirs(img_dir, exist_ok=True)
    os.makedirs(ann_dir, exist_ok=True)

    categories = [{"id": j + 1, "name": n}
                  for j, n in enumerate(VOC_CLASSES)]

    tr_imgs, tr_anns, tr_pix = _gen_images(
        rng, num_images, img_w, img_h, first_id=1,
        max_objects=max_objects, num_classes=num_classes,
        min_side=min_side, adversarial=adversarial)
    splits = {"trainval0712": (tr_imgs, tr_anns)}
    pixels = list(tr_pix)
    if test_images is None:
        splits["test2007"] = (tr_imgs, tr_anns)
    else:
        te_rng = np.random.RandomState(seed + 1)
        te_imgs, te_anns, te_pix = _gen_images(
            te_rng, test_images, img_w, img_h, first_id=num_images + 1,
            max_objects=max_objects, num_classes=num_classes,
            min_side=min_side, adversarial=adversarial)
        splits["test2007"] = (te_imgs, te_anns)
        pixels += te_pix

    if frames == "jpg":
        import cv2
        for images, _ in splits.values():
            for info in images:
                info["file_name"] = info["file_name"][:-4] + ".jpg"
        for fname, img in pixels:
            cv2.imwrite(os.path.join(img_dir, fname[:-4] + ".jpg"), img)
    else:
        for fname, img in pixels:
            write_png(os.path.join(img_dir, fname), img)
    for split, (images, annotations) in splits.items():
        db = {"images": images, "annotations": annotations,
              "categories": categories}
        with open(os.path.join(ann_dir,
                               "pascal_{}.json".format(split)), "w") as f:
            json.dump(db, f)
    return os.path.join(root, "voc")
