"""Run a trained detector on images and save what it detects (the JAX
package's root demo.py; the reference keeps `--demo` in lib/opts.py:25).

    python -m codenet_torch.cli.demo ctdet --demo <image or directory> \\
        --load_model exp/ctdet/<exp_id>/model_last.pth \\
        --arch shufflenetv2 --dataset pascal [--vis_thresh 0.3] \\
        [--flip_test] [--resume-quantize [--int8_infer]] [--gpus -1]

Every task the port serves runs (`detector_factory`); each image's
detections above --vis_thresh are drawn in the Debugger's class colours
and written as exp/<task>/<exp_id>/demo/<image name>.png. Images are read
as the detector reads them (engine/detector.py::imread: PNG without cv2);
the drawing needs cv2. Runs on the card unless ``--gpus -1``.
"""

from __future__ import annotations

import os
import sys

from .. import config as cfg
from ..data.image_io import write_png
from ..engine.detector import detector_factory, imread

IMG_EXTS = (".jpg", ".jpeg", ".png", ".webp", ".ppm", ".bmp")


def main(argv=None):
    from ..utils.debugger import Debugger
    opt = cfg.parse(argv)
    opt = cfg.update_dataset_info_and_set_heads(
        opt, cfg.DATASET_SPECS[opt.dataset])
    if not opt.demo:
        print("cli.demo needs --demo <image-or-directory>", file=sys.stderr)
        return 2
    if os.path.isdir(opt.demo):
        paths = sorted(
            os.path.join(opt.demo, f) for f in os.listdir(opt.demo)
            if f.lower().endswith(IMG_EXTS))
    else:
        paths = [opt.demo]
    if not paths:
        print("no images found under {}".format(opt.demo), file=sys.stderr)
        return 2

    detector = detector_factory(opt.task)(opt)
    out_dir = os.path.join(opt.save_dir, "demo")
    os.makedirs(out_dir, exist_ok=True)
    for path in paths:
        img = imread(path)
        ret = detector.run(img)
        debugger = Debugger(dataset=opt.dataset,
                            num_classes=opt.num_classes)
        debugger.add_img(img, img_id="demo")
        n_drawn = 0
        for cls_1based, dets in ret["results"].items():
            for det in dets:
                if det[4] >= opt.vis_thresh:
                    debugger.add_coco_bbox(det[:4], cls_1based - 1,
                                           det[4], img_id="demo")
                    n_drawn += 1
        out = os.path.join(out_dir, os.path.splitext(
            os.path.basename(path))[0] + ".png")
        write_png(out, debugger.imgs["demo"])
        print("{}: {} detections >= {} -> {} (net {:.3f}s)".format(
            path, n_drawn, opt.vis_thresh, out, ret["net"]))
    return 0


if __name__ == "__main__":
    sys.exit(main())
