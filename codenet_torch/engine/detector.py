"""Inference engine (reference lib/detectors/base_detector.py, ctdet.py,
ddd.py, multi_pose.py, exdet.py).

The serving paths of the JAX package's engine/detector.py in PyTorch. ctdet: letterbox pre-process on the host
(torch bilinear resize and warp stand in for cv2), then on the model's
device forward -> sigmoid -> flip-test averaging -> max-pool NMS top-k
decode -> affine back-projection, with only the (K, 6) detections copied
back; per class, the scales' detections are
merged on the host with soft-NMS (gaussian, Nt 0.5) when there is more
than one test scale or --nms is set, then cut to the global top 100.
Per-stage wall-clock timers mirror base_detector.py:93-155 ({tot, load,
pre, net, dec, post, merge}); on a card each stage ends in
``torch.cuda.synchronize``.

Served: ctdet, FP32, W4A8 fake-quant (``--resume-quantize``, with the
recipe a port checkpoint records) or real int8 (``--resume-quantize
--int8_infer``), each with f32 or bf16 convs (``--dtype bfloat16``;
checkpoints hold f32 tensors either way), its weights from a checkpoint
or from a W4A8 artifact
(``--w4a8_artifact``, engine/w4a8.py; a checkpoint's integer weights are
derived once, at construction); any test scales, ``fix_res`` or
``--keep_res``, with or without ``--flip_test``, uint8 or (with
``--host_normalize``) host-normalised f32 images, per image (`run`) or
batched: `process_batch` over pre-warped images, `process_batch_raw` over
raw frames warped on the device (``--device_warp``), and
`process_batch_cached` / `process_batches_cached` over rows of a
device-resident image stack (``--device_cache``). ``--device_cache_shard``
shards the train cache only: eval replicates its cache (cli/test.py
says so), as in the JAX package.

multi_pose (COCO keypoints): the same pre-process, then on the device
forward -> sigmoid -> flip-test averaging (joint channels swapped, x
offsets negated) -> decode with the keypoint-heatmap association; the
(K, 40) detections go back to image pixels on the host
(utils/post_process.py) and several scales or --nms merge with
soft_nms_39. Per image only, as in the JAX package.

ddd (KITTI 3D): the frame warped to (input_h, input_w) at one scale,
unflipped, then on the device forward -> sigmoid -> depth 1 / (sigmoid
+ 1e-6) - 1 -> decode; on the host the (K, 18) rows go back to image
pixels and to 3D through the request's calib (meta["calib"], else
DEFAULT_CALIB), kept above --peak_thresh. exdet (ExtremeNet): the ctdet
pre-process, then on the device forward -> sigmoid -> the K^4 extreme
point decode of each image of the flip-test pair; on the host the
flipped copy's boxes are mirrored back, the corners back-projected, and
per class the boxes merged with soft-NMS and cut to the top 100. Both per
image, as in the JAX package. Every task serves FP32, fake-quant and real
int8, from a checkpoint or a W4A8 artifact, as ctdet does.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from .. import resolve_device
from ..data.affine import (get_affine_transform, invert_affine, resize_u8,
                           transform_preds, warp_affine_batch,
                           warp_affine_u8)
from ..data.image_io import read_png
from ..models import create_model
from ..models import decode as D
from ..models.layers import qspec_from_opt
from ..ops.nms import soft_nms, soft_nms_39
from ..utils.post_process import ddd_post_process, multi_pose_post_process
from . import checkpoint, w4a8


def flip_w(x):
    """Horizontal flip, NHWC (reference models/utils.py:32-33)."""
    return torch.flip(x, dims=[2])


def _joint_perm(n, flip_idx):
    perm = list(range(n))
    for a, b in flip_idx:
        perm[a], perm[b] = perm[b], perm[a]
    return perm


def flip_lr(x, flip_idx):
    """Flip a joint heatmap stack (N, H, W, J): mirror W and swap the
    left/right joint channels (reference models/utils.py:38-44)."""
    return flip_w(x)[..., _joint_perm(x.shape[-1], flip_idx)]


def flip_lr_off(x, flip_idx):
    """Flip a joint-offset stack (N, H, W, 2J): mirror W, negate the x
    offsets and swap the joint pairs (reference models/utils.py:47-56)."""
    n, h, w, c = x.shape
    x = flip_w(x).reshape(n, h, w, c // 2, 2)
    x = torch.stack([-x[..., 0], x[..., 1]], dim=-1)
    return x[..., _joint_perm(c // 2, flip_idx), :].reshape(n, h, w, c)


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
    """BGR uint8 image from a file: a PNG through data/image_io.py's
    reader (no cv2; the pixels cv2.imread gives), any other format
    through cv2."""
    if path.lower().endswith(".png"):
        return read_png(path)
    try:
        import cv2
    except ImportError as e:
        raise RuntimeError(
            "reading {} needs OpenCV (cv2), which is not installed; PNG "
            "files need none, or pass decoded (H, W, 3) uint8 arrays"
            .format(path)) from e
    image = cv2.imread(path)
    if image is None:
        raise FileNotFoundError(path)
    return image


def device_from_opt(opt):
    """--gpus -1 -> cpu, anything else -> cuda (reference opts.py)."""
    return "cpu" if opt.gpus[0] < 0 else "cuda"


def check_unported_eval_flags(opt):
    """--trace is not ported (ROADMAP.md item 23): raise rather than run
    as if it were not set."""
    if getattr(opt, "trace", False):
        raise NotImplementedError(
            "--trace is queued in ROADMAP.md (item 23)")


class BaseDetector:
    def __init__(self, opt, state_dict=None, device=None):
        check_unported_eval_flags(opt)
        self.opt = opt
        if opt.w4a8_artifact and not (opt.resume_quantize
                                      and opt.int8_infer):
            raise ValueError(
                "--w4a8_artifact needs --resume-quantize --int8_infer: the "
                "artifact holds integer weights for the real-int8 path "
                "only")
        self.device = resolve_device(device or device_from_opt(opt))
        self.qspec = None
        if opt.resume_quantize:
            if opt.load_model:
                checkpoint.adopt_quant_recipe(opt, opt.load_model,
                                           opt.given_flags)
            self.qspec = qspec_from_opt(opt)
        self.model = create_model(opt.arch, opt.heads, opt.head_conv,
                                  w2=opt.w2, maxpool=opt.maxpool,
                                  qspec=self.qspec, dtype=opt.dtype,
                                  device=self.device)
        if state_dict is not None:
            self.model.load_state_dict(state_dict)
        elif opt.w4a8_artifact:
            w4a8.load_w4a8(opt.w4a8_artifact, self.model)
        elif opt.load_model:
            checkpoint.load_model(opt.load_model, self.model)
        if self.qspec is not None and self.qspec.int8_infer \
                and not opt.w4a8_artifact:
            # the integer weights derived once, as the exporter derives
            # them: the checkpoint serves its artifact's detections
            w4a8.deploy_from_weights(self.model, (opt.input_h, opt.input_w))

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
        """Resize one BGR uint8 frame by `scale`, then letterbox-warp it:
        to (input_h, input_w) with fix_res, or with --keep_res to the
        resized size padded up to a multiple of 32 (two resamplings, as in
        the reference). Returns (1, or 2 with flip_test, H, W, 3) uint8
        images (f32 normalised with --host_normalize) and meta."""
        height, width = image.shape[0:2]
        new_height = int(height * scale)
        new_width = int(width * scale)
        if self.opt.fix_res:
            inp_height, inp_width = self.opt.input_h, self.opt.input_w
            c = np.array([new_width / 2.0, new_height / 2.0],
                         dtype=np.float32)
            s = max(height, width) * 1.0
        else:
            inp_height = (new_height | self.opt.pad) + 1
            inp_width = (new_width | self.opt.pad) + 1
            c = np.array([new_width // 2, new_height // 2], dtype=np.float32)
            s = np.array([inp_width, inp_height], dtype=np.float32)
        warp_inv = get_affine_transform(c, s, 0, [inp_width, inp_height],
                                        inv=1)
        resized = resize_u8(image, new_width, new_height)
        inp_image = warp_affine_u8(resized, warp_inv, inp_height, inp_width)
        if self.opt.host_normalize:
            inp_image = ((inp_image / 255.0 - self.mean)
                         / self.std).astype(np.float32)
        images = inp_image[None]  # NHWC
        if self.opt.flip_test:
            images = np.concatenate((images, images[:, :, ::-1, :]), axis=0)
        out_h = inp_height // self.opt.down_ratio
        out_w = inp_width // self.opt.down_ratio
        trans_inv = get_affine_transform(
            c, s, 0, [out_w, out_h], inv=1).astype(np.float32)
        meta = {"c": c, "s": s, "out_height": out_h, "out_width": out_w,
                "trans_inv": trans_inv}
        return images, meta

    def _forward(self, images):
        """The model's heads; of a multi-stack model (hourglass) the last
        stack's, as the JAX package's fused_heads.eval_forward returns."""
        out = self.model(images)
        return out[-1] if isinstance(out, (list, tuple)) else out

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

        if self.opt.debug >= 1 and image is not None:
            self.show_results(image, results)
        return {"results": results, "tot": tot_time, "load": load_time,
                "pre": pre_time, "net": net_time, "dec": dec_time,
                "post": post_time, "merge": merge_time}

    def show_results(self, image, results):
        """--debug >= 1: the request's final detections above
        --vis_thresh drawn over its image, saved as
        det_<ms>_out.png in opt.debug_dir (headless; the JAX package's
        BaseDetector.show_results, for every task)."""
        from ..utils.debugger import Debugger
        debugger = Debugger(dataset=self.opt.dataset,
                            theme=self.opt.debugger_theme)
        debugger.add_img(image, img_id="out")
        for j in range(1, self.num_classes + 1):
            for bbox in results.get(j, []):
                bbox = np.asarray(bbox)
                if bbox[4] > self.opt.vis_thresh:
                    debugger.add_coco_bbox(bbox[:4], j - 1, bbox[4],
                                           img_id="out")
        debugger.save_all_imgs(self.opt.debug_dir, prefix="det_{}_".format(
            int(time.time() * 1000) % 1000000))


class CtdetDetector(BaseDetector):
    """2D-box detector (reference lib/detectors/ctdet.py)."""

    def _heads(self, images):
        """Forward + sigmoid (+ flip-test average of the two halves)."""
        output = self._forward(eval_input(images, self.mean, self.std))
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

    # -- device warp and image cache (the JAX package's
    #    engine/detector.py:267-424) -------------------------------------
    def pre_process_geometry(self, height, width):
        """The (warp_ti, trans_inv) pair of a raw (height, width) frame
        under the scale-1 fix_res letterbox: model-input px -> raw px, and
        output px -> raw px. The host half of the device-warp and cached
        paths, where the pixels never pass through the host warp."""
        c = np.array([width / 2.0, height / 2.0], dtype=np.float32)
        s = max(height, width) * 1.0
        inp_h, inp_w = self.opt.input_h, self.opt.input_w
        warp_ti = get_affine_transform(
            c, s, 0, [inp_w, inp_h], inv=1).astype(np.float32)
        out_h = inp_h // self.opt.down_ratio
        out_w = inp_w // self.opt.down_ratio
        trans_inv = get_affine_transform(
            c, s, 0, [out_w, out_h], inv=1).astype(np.float32)
        return warp_ti, trans_inv

    def pre_process_raw(self, image):
        """Host side of the device-warp path: the raw frame zero-padded
        into the fixed (max_h, max_w) buffer, and its two affines. None
        when the frame does not fit (the caller takes the host warp).

        The buffer is `opt._device_warp_hw` when the caller derived a
        tight one from the dataset's metadata (cli/test.py batched_test:
        every padded byte is copied to the card), else the square
        --device_warp_max_res."""
        hw = getattr(self.opt, "_device_warp_hw", None)
        max_h, max_w = hw or (self.opt.device_warp_max_res,) * 2
        height, width = image.shape[0:2]
        if height > max_h or width > max_w:
            return None
        warp_ti, trans_inv = self.pre_process_geometry(height, width)
        padded = np.zeros((max_h, max_w, 3), np.uint8)
        padded[:height, :width] = image
        return padded, warp_ti, trans_inv

    def _warped_input(self, frames, warp_tis, rows=None):
        """Letterbox warp on the device (f32, not rounded) of `frames`
        (N, H, W, 3) uint8 (zero-padded raw frames, or the image stack
        with `rows`), normalised, with the flipped copies after the
        originals under flip_test."""
        warped = warp_affine_batch(frames, self._to_device(
            np.asarray(warp_tis, np.float32)), self.opt.input_h,
            self.opt.input_w, rows=rows)
        mean = torch.as_tensor(self.mean.reshape(3), device=self.device)
        std = torch.as_tensor(self.std.reshape(3), device=self.device)
        images = (warped / 255.0 - mean) / std
        if self.opt.flip_test:
            images = torch.cat([images, flip_w(images)], dim=0)
        return images

    @torch.inference_mode()
    def process_batch_raw(self, raw_u8, warp_tis, trans_invs):
        """Device-warp batched eval: raw (B, max_h, max_w, 3) uint8 frames
        (pre_process_raw) -> warp -> normalise -> net -> decode ->
        back-projection. warp_tis: (B, 2, 3) model-input px -> raw px;
        trans_invs: (B, 2, 3). Returns (B, K, 6) on the device."""
        images = self._warped_input(self._to_device(raw_u8), warp_tis)
        hm, wh, reg = self._heads(images)
        ti = self._to_device(np.asarray(trans_invs, np.float32))
        return self._decode(hm, wh, reg, ti, 1.0)

    @torch.inference_mode()
    def process_batch_cached(self, cache_u8, img_idx, warp_tis, trans_invs):
        """`process_batch_raw` over rows `img_idx` of the device-resident
        (N, Hc, Wc, 3) stack (data/device_cache.py): per batch the host
        sends only row indices and affines. The gather is the warp's."""
        images = self._warped_input(
            cache_u8, warp_tis,
            rows=self._to_device(np.asarray(img_idx, np.int64)))
        hm, wh, reg = self._heads(images)
        ti = self._to_device(np.asarray(trans_invs, np.float32))
        return self._decode(hm, wh, reg, ti, 1.0)

    @torch.inference_mode()
    def process_batches_cached(self, cache_u8, img_idx, warp_tis,
                               trans_invs):
        """K cached batches in one call: img_idx (K, B), warp_tis and
        trans_invs (K, B, 2, 3). Returns (K, B, topk, 6) on the device;
        nothing waits for the card inside (the JAX package scans the K
        batches in one program)."""
        return torch.stack([
            self.process_batch_cached(cache_u8, img_idx[k], warp_tis[k],
                                      trans_invs[k])
            for k in range(len(img_idx))])

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
        """Concat scales + soft-NMS (several scales or --nms) + global
        top-100 (reference detectors/ctdet.py:59-74). Soft-NMS decays the
        scores in place; its keep list is ignored, as in the reference."""
        results = {}
        for j in range(1, self.num_classes + 1):
            results[j] = np.concatenate(
                [det[j] for det in detections], axis=0).astype(np.float32)
            if len(self.scales) > 1 or self.opt.nms:
                soft_nms(results[j], Nt=0.5, method=2)
        scores = np.hstack(
            [results[j][:, 4] for j in range(1, self.num_classes + 1)])
        if len(scores) > self.max_per_image:
            kth = len(scores) - self.max_per_image
            thresh = np.partition(scores, kth)[kth]
            for j in range(1, self.num_classes + 1):
                keep_inds = results[j][:, 4] >= thresh
                results[j] = results[j][keep_inds]
        return results


class MultiPoseDetector(BaseDetector):
    """COCO keypoints detector (reference lib/detectors/multi_pose.py)."""

    def _heads(self, images):
        """Forward + sigmoid (+ flip-test average of the two halves, the
        flipped half's joints swapped back)."""
        opt = self.opt
        output = self._forward(eval_input(images, self.mean, self.std))
        hm = output["hm"].sigmoid()
        hm_hp = output["hm_hp"] if opt.hm_hp else None
        if hm_hp is not None and not opt.mse_loss:
            hm_hp = hm_hp.sigmoid()
        wh, hps = output["wh"], output["hps"]
        reg = output["reg"] if opt.reg_offset else None
        hp_offset = output["hp_offset"] if opt.reg_hp_offset else None
        if opt.flip_test:
            b = hm.shape[0] // 2
            hm = (hm[:b] + flip_w(hm[b:])) / 2
            wh = (wh[:b] + flip_w(wh[b:])) / 2
            hps = (hps[:b] + flip_lr_off(hps[b:], opt.flip_idx)) / 2
            if hm_hp is not None:
                hm_hp = (hm_hp[:b] + flip_lr(hm_hp[b:], opt.flip_idx)) / 2
            reg = reg[:b] if reg is not None else None
            hp_offset = hp_offset[:b] if hp_offset is not None else None
        return hm, wh, hps, reg, hm_hp, hp_offset

    @torch.inference_mode()
    def process(self, images, trans_inv, scale, return_time=False):
        """One image: images (1, or 2 with flip_test, H, W, 3). Returns
        (1, K, 40) output-map detections on the device (and, with
        return_time, the host time at which the forward finished); the
        host post-process maps them back."""
        hm, wh, hps, reg, hm_hp, hp_offset = self._heads(
            self._to_device(images))
        self._sync()
        forward_time = time.time()
        dets = D.multi_pose_decode(hm, wh, hps, reg=reg, hm_hp=hm_hp,
                                   hp_offset=hp_offset, k=self.opt.K)
        return (dets, forward_time) if return_time else dets

    def post_process(self, dets, meta, scale=1):
        dets = np.asarray(dets).reshape(1, -1, dets.shape[2])
        dets = multi_pose_post_process(
            dets.copy(), [meta["c"]], [meta["s"]], meta["out_height"],
            meta["out_width"])
        for j in range(1, self.num_classes + 1):
            dets[0][j] = np.array(dets[0][j], dtype=np.float32).reshape(
                -1, 39)
            dets[0][j][:, :4] /= scale
            dets[0][j][:, 5:] /= scale
        return dets[0]

    def merge_outputs(self, detections):
        """Concat the scales; soft_nms_39 for several scales or --nms
        (reference detectors/multi_pose.py:80-88). No top-100 cut."""
        results = {1: np.concatenate([d[1] for d in detections],
                                     axis=0).astype(np.float32)}
        if self.opt.nms or len(self.scales) > 1:
            soft_nms_39(results[1], Nt=0.5, method=2)
        results[1] = results[1].tolist()
        return results


class DddDetector(BaseDetector):
    """KITTI 3D detector (reference lib/detectors/ddd.py)."""

    DEFAULT_CALIB = np.array([[707.0493, 0, 604.0814, 45.75831],
                              [0, 707.0493, 180.5066, -0.3454157],
                              [0, 0, 1.0, 0.004981016]], dtype=np.float32)

    def __init__(self, opt, state_dict=None, device=None):
        super().__init__(opt, state_dict, device)
        self.calib = self.DEFAULT_CALIB

    def pre_process(self, image, scale, meta=None):
        """reference detectors/ddd.py:30-56: no scaling and no flip; the
        frame's box (or, with --keep_res, the input size) letterboxed to
        (input_h, input_w). meta["calib"], when given, is the request's
        calibration."""
        height, width = image.shape[0:2]
        inp_height, inp_width = self.opt.input_h, self.opt.input_w
        c = np.array([width / 2, height / 2], dtype=np.float32)
        if self.opt.keep_res:
            s = np.array([inp_width, inp_height], dtype=np.int32)
        else:
            s = np.array([width, height], dtype=np.int32)
        trans_input = get_affine_transform(c, s, 0, [inp_width, inp_height])
        inp_image = warp_affine_u8(image, invert_affine(trans_input),
                                   inp_height, inp_width)
        if self.opt.host_normalize:
            inp_image = ((inp_image.astype(np.float32) / 255.0 - self.mean)
                         / self.std).astype(np.float32)
        calib = meta["calib"] if meta is not None and "calib" in meta \
            else self.calib
        meta = {"c": c, "s": s,
                "out_height": inp_height // self.opt.down_ratio,
                "out_width": inp_width // self.opt.down_ratio,
                "calib": calib, "trans_inv": np.zeros((2, 3), np.float32)}
        return inp_image[None], meta

    @torch.inference_mode()
    def process(self, images, trans_inv, scale, return_time=False):
        """images (1, H, W, 3). Returns (1, K, 18) output-map detections
        on the device (and, with return_time, the host time at which the
        forward finished)."""
        opt = self.opt
        output = self._forward(eval_input(self._to_device(images),
                                          self.mean, self.std))
        hm = output["hm"].sigmoid()
        dep = 1.0 / (output["dep"].sigmoid() + 1e-6) - 1.0
        self._sync()
        forward_time = time.time()
        dets = D.ddd_decode(hm, output["rot"], dep, output["dim"],
                            wh=output["wh"] if opt.reg_bbox else None,
                            reg=output["reg"] if opt.reg_offset else None,
                            k=opt.K)
        return (dets, forward_time) if return_time else dets

    def post_process(self, dets, meta, scale=1):
        """Per class (n, 14) [alpha box dim location rotation_y score],
        in image pixels and camera coordinates of the request's calib."""
        detections = ddd_post_process(
            np.array(dets), [meta["c"]], [meta["s"]], [meta["calib"]],
            self.opt)
        self.this_calib = meta["calib"]
        return detections[0]

    def merge_outputs(self, detections):
        """The one scale's detections above --peak_thresh."""
        results = detections[0]
        for j in range(1, self.num_classes + 1):
            if len(results[j]) > 0:
                keep_inds = results[j][:, -1] > self.opt.peak_thresh
                results[j] = results[j][keep_inds]
        return results


class ExdetDetector(BaseDetector):
    """ExtremeNet detector (reference lib/detectors/exdet.py)."""

    @torch.inference_mode()
    def process(self, images, trans_inv, scale, return_time=False):
        """images (1, or 2 with flip_test, H, W, 3); each image decoded on
        its own. Returns (1 or 2, num_dets, 14) output-map detections on
        the device (and, with return_time, the host time at which the
        forward finished)."""
        opt = self.opt
        output = self._forward(eval_input(self._to_device(images),
                                          self.mean, self.std))
        heats = [output["hm_" + p].sigmoid() for p in "tlbrc"]
        regrs = [output["reg_" + p] if opt.reg_offset else None
                 for p in "tlbr"]
        self._sync()
        forward_time = time.time()
        dets = D.exct_decode(*heats, *regrs, k=opt.K,
                             scores_thresh=opt.scores_thresh,
                             center_thresh=opt.center_thresh,
                             aggr_weight=opt.aggr_weight,
                             agnostic=opt.agnostic_ex)
        return (dets, forward_time) if return_time else dets

    def post_process(self, dets, meta, scale=1):
        """reference detectors/exdet.py:86-98: the flipped copy's boxes
        mirrored back, the box corners back-projected to image pixels."""
        out_width, out_height = meta["out_width"], meta["out_height"]
        dets = np.array(dets)
        if dets.shape[0] == 2:  # flip-test pair
            dets = dets.reshape(2, -1, 14)
            dets[1, :, [0, 2]] = out_width - dets[1, :, [2, 0]]
        dets = dets.reshape(1, -1, 14)
        dets[0, :, 0:2] = transform_preds(dets[0, :, 0:2], meta["c"],
                                          meta["s"], (out_width, out_height))
        dets[0, :, 2:4] = transform_preds(dets[0, :, 2:4], meta["c"],
                                          meta["s"], (out_width, out_height))
        dets[:, :, 0:4] /= scale
        return dets[0]

    def merge_outputs(self, detections):
        """reference detectors/exdet.py:100-124: the rows of score > 0, per
        class soft-NMS (gaussian, Nt 0.5; its keep list ignored), then the
        global top 100."""
        detections = np.concatenate(list(detections), axis=0).astype(
            np.float32)
        classes = detections[..., -1]
        keep_inds = detections[:, 4] > 0
        detections = detections[keep_inds]
        classes = classes[keep_inds]

        results = {}
        for j in range(self.num_classes):
            keep_inds = classes == j
            results[j + 1] = detections[keep_inds][:, 0:7].astype(np.float32)
            soft_nms(results[j + 1], Nt=0.5, method=2)
            results[j + 1] = results[j + 1][:, 0:5]
        scores = np.hstack([results[j][:, -1]
                            for j in range(1, self.num_classes + 1)])
        if len(scores) > self.max_per_image:
            kth = len(scores) - self.max_per_image
            thresh = np.partition(scores, kth)[kth]
            for j in range(1, self.num_classes + 1):
                keep_inds = results[j][:, -1] >= thresh
                results[j] = results[j][keep_inds]
        return results


DETECTOR_FACTORY = {
    "ctdet": CtdetDetector,
    "ddd": DddDetector,
    "multi_pose": MultiPoseDetector,
    "exdet": ExdetDetector,
}


def detector_factory(task):
    """reference lib/detectors/detector_factory.py:11-16."""
    if task not in DETECTOR_FACTORY:
        raise NotImplementedError("no detector for task {}; the tasks are "
                                  "{}".format(task, sorted(DETECTOR_FACTORY)))
    return DETECTOR_FACTORY[task]
