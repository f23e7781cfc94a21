"""Inference engine (reference lib/detectors/base_detector.py, ctdet.py).

The ctdet serving path of the JAX package's engine/detector.py in PyTorch:
letterbox pre-process on the host (a torch bilinear warp stands in for
cv2), then on the model's device forward -> sigmoid -> flip-test averaging
-> max-pool NMS top-k decode -> affine back-projection, with only the
(K, 6) detections copied back. Per-stage wall-clock timers mirror
base_detector.py:93-155 ({tot, load, pre, net, dec, post, merge}); on a
card each stage ends in ``torch.cuda.synchronize``.

Served so far: ctdet, FP32 or W4A8 fake-quant (``--resume-quantize``,
with the recipe a port checkpoint records), single test scale 1 with
``fix_res``, with or without ``--flip_test``, per image (`run`) or batched
(`process_batch`). Other options (real int8, the W4A8 artifact, soft-NMS,
multi-scale, keep_res) raise and are queued in ROADMAP.md.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from .. import resolve_device
from ..data.affine import get_affine_transform, warp_affine_u8
from ..models import create_model
from ..models import decode as D
from ..models.layers import qspec_from_opt
from . import checkpoint


def flip_w(x):
    """Horizontal flip, NHWC (reference models/utils.py:32-33)."""
    return torch.flip(x, dims=[2])


def eval_input(images, mean, std):
    """Eval normalization on the device: uint8 images become
    (x / 255 - mean) / std in f32; float inputs pass through."""
    if images.dtype != torch.uint8:
        return images
    mean = torch.as_tensor(np.asarray(mean, np.float32).reshape(3),
                           device=images.device)
    std = torch.as_tensor(np.asarray(std, np.float32).reshape(3),
                          device=images.device)
    return (images.float() / 255.0 - mean) / std


def imread(path):
    """BGR uint8 image from a file. Only this host I/O needs cv2."""
    try:
        import cv2
    except ImportError as e:
        raise RuntimeError(
            "reading image files needs OpenCV (cv2), which is not "
            "installed; pass decoded (H, W, 3) uint8 arrays instead") from e
    image = cv2.imread(path)
    if image is None:
        raise FileNotFoundError(path)
    return image


def device_from_opt(opt):
    """--gpus -1 -> cpu, anything else -> cuda (reference opts.py)."""
    return "cpu" if opt.gpus[0] < 0 else "cuda"


class BaseDetector:
    def __init__(self, opt, state_dict=None, device=None):
        self.opt = opt
        if opt.int8_infer or opt.w4a8_artifact:
            raise NotImplementedError(
                "real-int8 eval and the W4A8 artifact are queued in "
                "ROADMAP.md")
        if opt.nms or len(opt.test_scales) != 1 or opt.test_scales[0] != 1:
            raise NotImplementedError(
                "--nms and multi-scale test need soft-NMS, queued in "
                "ROADMAP.md")
        if not opt.fix_res:
            raise NotImplementedError(
                "--keep_res pre-process needs a resize, queued in "
                "ROADMAP.md")
        self.device = resolve_device(device or device_from_opt(opt))
        self.qspec = None
        if opt.resume_quantize:
            if opt.load_model:
                checkpoint.adopt_quant_recipe(opt, opt.load_model)
            self.qspec = qspec_from_opt(opt)
        self.model = create_model(opt.arch, opt.heads, opt.head_conv,
                                  w2=opt.w2, maxpool=opt.maxpool,
                                  qspec=self.qspec, dtype=opt.dtype,
                                  device=self.device)
        if state_dict is not None:
            self.model.load_state_dict(state_dict)
        elif opt.load_model:
            checkpoint.load_model(opt.load_model, self.model)

        self.mean = np.array(opt.mean, dtype=np.float32).reshape(1, 1, 3)
        self.std = np.array(opt.std, dtype=np.float32).reshape(1, 1, 3)
        self.max_per_image = 100
        self.num_classes = opt.num_classes
        self.scales = opt.test_scales

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # -- host-side preprocessing (reference base_detector.py:48-76) -------
    def pre_process(self, image, scale, meta=None):
        """Letterbox warp of one BGR uint8 frame at scale 1 (fix_res):
        (1 or 2 with flip_test, H, W, 3) uint8 images + meta."""
        if scale != 1:
            raise NotImplementedError(
                "test scales other than 1 need a resize, queued in "
                "ROADMAP.md")
        height, width = image.shape[0:2]
        inp_height, inp_width = self.opt.input_h, self.opt.input_w
        c = np.array([width / 2.0, height / 2.0], dtype=np.float32)
        s = max(height, width) * 1.0
        warp_inv = get_affine_transform(c, s, 0, [inp_width, inp_height],
                                        inv=1)
        images = warp_affine_u8(image, warp_inv, inp_height,
                                inp_width)[None]  # NHWC
        if self.opt.flip_test:
            images = np.concatenate((images, images[:, :, ::-1, :]), axis=0)
        out_h = inp_height // self.opt.down_ratio
        out_w = inp_width // self.opt.down_ratio
        trans_inv = get_affine_transform(
            c, s, 0, [out_w, out_h], inv=1).astype(np.float32)
        meta = {"c": c, "s": s, "out_height": out_h, "out_width": out_w,
                "trans_inv": trans_inv}
        return images, meta

    def _to_device(self, array):
        return torch.from_numpy(np.ascontiguousarray(array)).to(
            self.device)

    def process(self, images, trans_inv, scale, return_time=False):
        raise NotImplementedError

    def post_process(self, dets, meta, scale=1):
        raise NotImplementedError

    def merge_outputs(self, detections):
        raise NotImplementedError

    # -- timed driver (reference base_detector.py:93-155) -----------------
    def run(self, image_or_path_or_tensor, meta=None):
        load_time, pre_time, net_time, dec_time, post_time = 0, 0, 0, 0, 0
        merge_time, tot_time = 0, 0
        start_time = time.time()
        pre_processed = False
        if isinstance(image_or_path_or_tensor, np.ndarray):
            image = image_or_path_or_tensor
        elif isinstance(image_or_path_or_tensor, str):
            image = imread(image_or_path_or_tensor)
        else:
            image = image_or_path_or_tensor["image"]
            pre_processed_images = image_or_path_or_tensor
            pre_processed = True
        loaded_time = time.time()
        load_time += loaded_time - start_time

        detections = []
        for scale in self.scales:
            scale_start_time = time.time()
            if not pre_processed:
                images, meta = self.pre_process(image, scale, meta)
            else:
                images = pre_processed_images["images"][scale]
                meta = pre_processed_images["meta"][scale]
            pre_process_time = time.time()
            pre_time += pre_process_time - scale_start_time

            dets, forward_time = self.process(images, meta["trans_inv"],
                                              scale, return_time=True)
            dets = dets.cpu().numpy()  # waits for the device
            decode_time = time.time()
            net_time += forward_time - pre_process_time
            dec_time += decode_time - forward_time

            dets = self.post_process(dets, meta, scale)
            post_process_time = time.time()
            post_time += post_process_time - decode_time
            detections.append(dets)

        results = self.merge_outputs(detections)
        end_time = time.time()
        merge_time += end_time - post_process_time
        tot_time += end_time - start_time
        return {"results": results, "tot": tot_time, "load": load_time,
                "pre": pre_time, "net": net_time, "dec": dec_time,
                "post": post_time, "merge": merge_time}


class CtdetDetector(BaseDetector):
    """2D-box detector (reference lib/detectors/ctdet.py)."""

    def _heads(self, images):
        """Forward + sigmoid (+ flip-test average of the two halves)."""
        output = self.model(eval_input(images, self.mean, self.std))
        hm = output["hm"].sigmoid()
        wh = output["wh"]
        reg = output["reg"] if self.opt.reg_offset else None
        if self.opt.flip_test:
            # [originals; flipped] (reference detectors/ctdet.py:35-38)
            b = hm.shape[0] // 2
            hm = (hm[:b] + flip_w(hm[b:])) / 2
            wh = (wh[:b] + flip_w(wh[b:])) / 2
            reg = reg[:b] if reg is not None else None
        return hm, wh, reg

    def _decode(self, hm, wh, reg, trans_inv, inv_scale):
        dets = D.ctdet_decode(hm, wh, reg=reg,
                              cat_spec_wh=self.opt.cat_spec_wh, k=self.opt.K)
        return D.backproject_dets(dets, trans_inv, inv_scale)

    @torch.inference_mode()
    def process(self, images, trans_inv, scale, return_time=False):
        """One image: images (1, or 2 with flip_test, H, W, 3) uint8 or
        normalized f32; trans_inv (2, 3) output -> original affine.
        Returns (1, K, 6) detections on the device (and, with
        return_time, the host time at which the forward finished)."""
        hm, wh, reg = self._heads(self._to_device(images))
        self._sync()
        forward_time = time.time()
        ti = self._to_device(np.asarray(trans_inv, np.float32)[None])
        dets = self._decode(hm, wh, reg, ti, 1.0 / scale)
        return (dets, forward_time) if return_time else dets

    @torch.inference_mode()
    def process_batch(self, images, trans_invs):
        """Batched single-scale eval (an extension; the reference
        evaluates image by image). images: (B, H, W, 3) or, with
        flip_test, (2B, ...) laid out [originals; flipped]; trans_invs:
        (B, 2, 3). Returns (B, K, 6) detections on the device."""
        hm, wh, reg = self._heads(self._to_device(images))
        ti = self._to_device(np.asarray(trans_invs, np.float32))
        return self._decode(hm, wh, reg, ti, 1.0)

    def post_process(self, dets, meta, scale=1):
        """Bucket image-space dets by 1-based class (back-projection and
        /scale already ran on the device)."""
        dets = np.asarray(dets).reshape(-1, 6)
        ret = {}
        for j in range(1, self.num_classes + 1):
            inds = dets[:, 5] == (j - 1)
            ret[j] = dets[inds, :5].astype(np.float32).reshape(-1, 5)
        return ret

    def merge_outputs(self, detections):
        """Concat scales + global top-100 (reference detectors/ctdet.py:
        59-74; soft-NMS is refused at construction)."""
        results = {}
        for j in range(1, self.num_classes + 1):
            results[j] = np.concatenate(
                [det[j] for det in detections], axis=0).astype(np.float32)
        scores = np.hstack(
            [results[j][:, 4] for j in range(1, self.num_classes + 1)])
        if len(scores) > self.max_per_image:
            kth = len(scores) - self.max_per_image
            thresh = np.partition(scores, kth)[kth]
            for j in range(1, self.num_classes + 1):
                keep_inds = results[j][:, 4] >= thresh
                results[j] = results[j][keep_inds]
        return results


DETECTOR_FACTORY = {
    "ctdet": CtdetDetector,
}


def detector_factory(task):
    """reference lib/detectors/detector_factory.py:11-16."""
    if task not in DETECTOR_FACTORY:
        raise NotImplementedError(
            "task {} is queued in ROADMAP.md".format(task))
    return DETECTOR_FACTORY[task]
