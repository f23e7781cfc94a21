"""Training targets of the four CenterNet tasks (the JAX package's
data/samplers.py; reference lib/datasets/sample/{ctdet,ddd,multi_pose,
exdet}.py), host numpy.

`get_sample(index, rng)` returns fixed-shape numpy arrays ready to batch.
The ctdet sampler's input comes in one of three forms:

- device mode (the default): the warped uint8 image with 7 floats of
  colour-aug state (normalised and augmented on the device,
  data/device_aug.py) and the sparse object list the device renders the
  heatmap from;
- image cache mode (--device_cache, data/device_cache.py; train split):
  no pixels are read or warped, the sample carries the row `img_idx` and
  the warp matrix `warp_ti` (flip folded in) beside the aug state and the
  sparse targets;
- host mode (--host_normalize, the reference's path): the f32 image,
  colour-augmented and normalised here, and the dense heatmap.

The ddd, multi_pose and exdet samplers take the device or the host mode;
their targets are dense on the host in either, as the JAX samplers emit
them. So are ctdet's under --mse_loss or --dense_wh, in every mode (the
image cache's batches too): the JAX sampler ships the sparse heatmap
only without both. The ddd sampler has no colour aug (identity aug
state), as in the reference.

Draws come from `rng` in the JAX sampler's order, so the same per-batch
RandomState gives the same sample in every mode. ``draw_only=True``
makes a sample's draws alone and returns None: a data-parallel rank
replays the draws of the rows of a batch that other ranks build
(data/loader.py). The draws need the frame's dimensions only, taken from
the image cache's records, or decoded once and remembered
(`frame_dims`). The warp is the port's
torch `warp_affine_u8`, not cv2 (the port needs no cv2); images
come from the dataset's `load_image`, which a caller may override (e.g.
with in-memory frames).

The dense targets: --mse_loss draws MSRA gaussians (std --hm_gauss for
ctdet's and multi_pose's heatmaps, the object's radius for ddd's and
exdet's); --dense_wh (ctdet) a dense box-size map and its mask in place
of `wh`; --dense_hp (multi_pose) dense joint offsets and their mask in
place of `hps`. They draw no random number.
"""

from __future__ import annotations

import math
import os

import numpy as np

from .affine import (affine_transform, draw_dense_reg, draw_msra_gaussian,
                     draw_umich_gaussian, gaussian_radius,
                     get_affine_transform, invert_affine, warp_affine_u8)
from .device_aug import draw_color_aug_params, identity_aug_params
from .device_cache import flip_compose
from .image_aug import color_aug

def finish_input(sampler, inp_u8, is_train, rng):
    """Input tail. Device mode: 'input_u8' plus the colour-aug state (the
    trainer runs device_aug on the card); inp_u8=None is the image cache
    mode (the aug state alone; the caller adds img_idx and warp_ti).
    --host_normalize: the reference's host path, /255 -> color_aug ->
    normalise, an f32 'input'."""
    if getattr(sampler.opt, "host_normalize", False):
        if inp_u8 is None:
            raise ValueError("--device_cache requires the device input "
                             "path (drop --host_normalize)")
        inp = inp_u8.astype(np.float32) / 255.0
        if is_train and not sampler.opt.no_color_aug:
            color_aug(rng, inp, sampler._eig_val, sampler._eig_vec,
                      py_random=rng)
        inp = (inp - sampler.mean) / sampler.std
        return {"input": inp.astype(np.float32)}
    if is_train and not sampler.opt.no_color_aug:
        perm, alphas, light = draw_color_aug_params(
            rng, sampler._eig_val, sampler._eig_vec, py_random=rng)
    else:
        perm, alphas, light = identity_aug_params()
    fields = {"aug_perm": np.int32(perm), "aug_alphas": alphas,
              "aug_light": light}
    if inp_u8 is not None:
        fields["input_u8"] = np.ascontiguousarray(inp_u8)
    return fields


def draw_input_aug(sampler, is_train, rng):
    """The draws of `finish_input` without an image (a draw-only sample):
    the colour-aug state, drawn as --host_normalize's color_aug draws
    it."""
    if is_train and not sampler.opt.no_color_aug:
        draw_color_aug_params(rng, sampler._eig_val, sampler._eig_vec,
                              py_random=rng)


def frame_dims(sampler, index):
    """(height, width) of frame `index` as `load_image` decodes it,
    decoded once per process and remembered."""
    memo = sampler.__dict__.setdefault("_frame_dims", {})
    if index not in memo:
        memo[index] = tuple(sampler.load_image(index).shape[:2])
    return memo[index]


def coco_box_to_bbox(box):
    return np.array([box[0], box[1], box[0] + box[2], box[1] + box[3]],
                    dtype=np.float32)


def get_border(border, size):
    """Random-crop border heuristic (reference sample/ctdet.py:24-28)."""
    i = 1
    while size - border // i <= border // i:
        i *= 2
    return border // i


def gaussian_of(opt):
    """The heatmap splat: MSRA gaussians under --mse_loss, else CenterNet's
    (reference sample/*.py: draw_gaussian)."""
    return draw_msra_gaussian if opt.mse_loss else draw_umich_gaussian


def splat(heat, ch, ct, radius, draw=draw_umich_gaussian):
    """Max-splat a gaussian (`draw`) at `ct` into channel `ch` of the
    (H, W, C) heatmap `heat`, in place."""
    sl = np.ascontiguousarray(heat[:, :, ch])
    draw(sl, ct, radius)
    heat[:, :, ch] = sl


class CTDetSampler:
    """2D-box detection targets (reference sample/ctdet.py:30-146)."""

    def get_sample(self, index, rng=None, draw_only=False):
        """One sample; `rng` (np.random.RandomState) draws the crop, flip
        and colour aug, by default the dataset's own stream. draw_only:
        the draws alone (returns None)."""
        rng = rng if rng is not None else self._data_rng
        img_id = self.images[index]
        anns = self.coco.loadAnns(ids=self.coco.getAnnIds(imgIds=[img_id]))
        # image cache mode: the pixels sit on the card; the host needs
        # only the frame's dims and ships the warp matrix (train split:
        # the trainer holds one cache, built over its train dataset)
        cache_dims = getattr(self, "_image_cache_dims", None)
        use_cache = cache_dims is not None and self.split == "train"
        if use_cache:
            img = None
            height, width = int(cache_dims[index][0]), \
                int(cache_dims[index][1])
        elif draw_only:
            img = None
            height, width = frame_dims(self, index)
        else:
            img = self.load_image(index)
            height, width = img.shape[0], img.shape[1]
        num_objs = min(len(anns), self.max_objs)
        c = np.array([width / 2.0, height / 2.0], dtype=np.float32)
        if self.opt.keep_res:
            input_h = (height | self.opt.pad) + 1
            input_w = (width | self.opt.pad) + 1
            s = np.array([input_w, input_h], dtype=np.float32)
        else:
            s = max(height, width) * 1.0
            input_h, input_w = self.opt.input_h, self.opt.input_w

        flipped = False
        if self.split == "train":
            if not self.opt.not_rand_crop:
                s = s * rng.choice(np.arange(0.6, 1.4, 0.1))
                w_border = get_border(128, width)
                h_border = get_border(128, height)
                c[0] = rng.randint(low=w_border, high=width - w_border)
                c[1] = rng.randint(low=h_border, high=height - h_border)
            else:
                sf = self.opt.scale
                cf = self.opt.shift
                c[0] += s * np.clip(rng.randn() * cf, -2 * cf, 2 * cf)
                c[1] += s * np.clip(rng.randn() * cf, -2 * cf, 2 * cf)
                s = s * np.clip(rng.randn() * sf + 1, 1 - sf, 1 + sf)
            if rng.random() < self.opt.flip:
                flipped = True
                if img is not None:
                    img = img[:, ::-1, :]
                c[0] = width - c[0] - 1

        if draw_only:
            draw_input_aug(self, self.split == "train", rng)
            return None
        if use_cache:
            ti = get_affine_transform(c, s, 0, [input_w, input_h], inv=1)
            if flipped:
                ti = flip_compose(ti, width)
            ret = finish_input(self, None, True, rng)
            ret.update(img_idx=np.int32(index),
                       warp_ti=np.asarray(ti, np.float32))
        else:
            trans_input = get_affine_transform(c, s, 0, [input_w, input_h])
            inp_u8 = warp_affine_u8(img, invert_affine(trans_input),
                                    input_h, input_w)
            ret = finish_input(self, inp_u8, self.split == "train", rng)

        output_h = input_h // self.opt.down_ratio
        output_w = input_w // self.opt.down_ratio
        num_classes = self.num_classes
        trans_output = get_affine_transform(c, s, 0, [output_w, output_h])

        # the device renders the heatmap from (ct, radius, cls); the host
        # path, --mse_loss and --dense_wh (which reads the heatmap as it
        # draws) draw it here, as the reference does
        opt = self.opt
        sparse_hm = ("input" not in ret and not opt.mse_loss
                     and not opt.dense_wh)
        draw = gaussian_of(opt)
        hm = np.zeros((output_h, output_w, num_classes), dtype=np.float32)
        hm_ct = np.zeros((self.max_objs, 2), dtype=np.int32)
        hm_radius = np.zeros((self.max_objs,), dtype=np.int32)
        hm_cls = np.zeros((self.max_objs,), dtype=np.int32)
        wh = np.zeros((self.max_objs, 2), dtype=np.float32)
        dense_wh = np.zeros((2, output_h, output_w), dtype=np.float32)
        reg = np.zeros((self.max_objs, 2), dtype=np.float32)
        ind = np.zeros((self.max_objs,), dtype=np.int64)
        reg_mask = np.zeros((self.max_objs,), dtype=np.uint8)
        cat_spec_wh = np.zeros((self.max_objs, num_classes * 2),
                               dtype=np.float32)
        cat_spec_mask = np.zeros((self.max_objs, num_classes * 2),
                                 dtype=np.uint8)

        gt_det = []
        for k in range(num_objs):
            ann = anns[k]
            bbox = coco_box_to_bbox(ann["bbox"])
            cls_id = int(self.cat_ids[ann["category_id"]])
            if flipped:
                bbox[[0, 2]] = width - bbox[[2, 0]] - 1
            bbox[:2] = affine_transform(bbox[:2], trans_output)
            bbox[2:] = affine_transform(bbox[2:], trans_output)
            bbox[[0, 2]] = np.clip(bbox[[0, 2]], 0, output_w - 1)
            bbox[[1, 3]] = np.clip(bbox[[1, 3]], 0, output_h - 1)
            h, w = bbox[3] - bbox[1], bbox[2] - bbox[0]
            if h > 0 and w > 0:
                radius = gaussian_radius((math.ceil(h), math.ceil(w)))
                radius = max(0, int(radius))
                radius = opt.hm_gauss if opt.mse_loss else radius
                ct = np.array([(bbox[0] + bbox[2]) / 2,
                               (bbox[1] + bbox[3]) / 2], dtype=np.float32)
                ct_int = ct.astype(np.int32)
                if sparse_hm:
                    hm_ct[k] = ct_int
                    hm_radius[k] = radius
                    hm_cls[k] = cls_id
                else:
                    splat(hm, cls_id, ct_int, radius, draw)
                wh[k] = 1.0 * w, 1.0 * h
                ind[k] = ct_int[1] * output_w + ct_int[0]
                reg[k] = ct - ct_int
                reg_mask[k] = 1
                cat_spec_wh[k, cls_id * 2: cls_id * 2 + 2] = wh[k]
                cat_spec_mask[k, cls_id * 2: cls_id * 2 + 2] = 1
                if opt.dense_wh:
                    draw_dense_reg(dense_wh, hm.max(axis=2), ct_int, wh[k],
                                   radius)
                gt_det.append([ct[0] - w / 2, ct[1] - h / 2,
                               ct[0] + w / 2, ct[1] + h / 2, 1, cls_id])

        ret.update(reg_mask=reg_mask, ind=ind, wh=wh)
        if sparse_hm:
            ret.update(hm_ct=hm_ct, hm_radius=hm_radius, hm_cls=hm_cls)
        else:
            ret["hm"] = hm
        if opt.dense_wh:
            hm_a = hm.max(axis=2, keepdims=True)
            ret.update(dense_wh=np.ascontiguousarray(
                dense_wh.transpose(1, 2, 0)),
                dense_wh_mask=np.concatenate([hm_a, hm_a], axis=2))
            del ret["wh"]
        elif opt.cat_spec_wh:
            ret.update(cat_spec_wh=cat_spec_wh, cat_spec_mask=cat_spec_mask)
            del ret["wh"]
        if self.opt.reg_offset:
            ret["reg"] = reg
        if self.opt.debug > 0 or not self.split == "train":
            gt_det = np.array(gt_det, dtype=np.float32) if gt_det \
                else np.zeros((1, 6), dtype=np.float32)
            ret["meta"] = {"c": c, "s": s, "gt_det": gt_det,
                           "img_id": img_id}
        return ret


class MultiPoseSampler:
    """COCO keypoint targets (reference sample/multi_pose.py:30-184): the
    person heatmap, box size and offset, the 17 joints' offsets from the
    centre (hps), their heatmaps (hm_hp) and sub-pixel offsets, all dense
    or fixed-size on the host in the JAX sampler's dtypes."""

    def get_sample(self, index, rng=None, draw_only=False):
        rng = rng if rng is not None else self._data_rng
        img_id = self.images[index]
        anns = self.coco.loadAnns(self.coco.getAnnIds(imgIds=[img_id]))
        num_objs = min(len(anns), self.max_objs)
        if draw_only:
            img = None
            height, width = frame_dims(self, index)
        else:
            img = self.load_image(index)
            height, width = img.shape[0], img.shape[1]
        c = np.array([width / 2.0, height / 2.0], dtype=np.float32)
        s = max(height, width) * 1.0
        rot = 0

        flipped = False
        if self.split == "train":
            if not self.opt.not_rand_crop:
                s = s * rng.choice(np.arange(0.6, 1.4, 0.1))
                w_border = get_border(128, width)
                h_border = get_border(128, height)
                c[0] = rng.randint(low=w_border, high=width - w_border)
                c[1] = rng.randint(low=h_border, high=height - h_border)
            else:
                sf, cf = self.opt.scale, self.opt.shift
                c[0] += s * np.clip(rng.randn() * cf, -2 * cf, 2 * cf)
                c[1] += s * np.clip(rng.randn() * cf, -2 * cf, 2 * cf)
                s = s * np.clip(rng.randn() * sf + 1, 1 - sf, 1 + sf)
            if rng.random() < self.opt.aug_rot:
                rf = self.opt.rotate
                rot = np.clip(rng.randn() * rf, -rf * 2, rf * 2)
            if rng.random() < self.opt.flip:
                flipped = True
                c[0] = width - c[0] - 1
                if img is not None:
                    img = img[:, ::-1, :]

        if draw_only:
            draw_input_aug(self, self.split == "train", rng)
            return None
        input_res = self.opt.input_res
        trans_input = get_affine_transform(c, s, rot, [input_res, input_res])
        inp_u8 = warp_affine_u8(img, invert_affine(trans_input), input_res,
                                input_res)
        ret = finish_input(self, inp_u8, self.split == "train", rng)

        output_res = self.opt.output_res
        num_joints = self.num_joints
        trans_output_rot = get_affine_transform(c, s, rot,
                                                [output_res, output_res])
        trans_output = get_affine_transform(c, s, 0,
                                            [output_res, output_res])

        hm = np.zeros((output_res, output_res, self.num_classes), np.float32)
        hm_hp = np.zeros((output_res, output_res, num_joints), np.float32)
        dense_kps = np.zeros((num_joints, 2, output_res, output_res),
                             np.float32)
        dense_kps_mask = np.zeros((num_joints, output_res, output_res),
                                  np.float32)
        wh = np.zeros((self.max_objs, 2), np.float32)
        kps = np.zeros((self.max_objs, num_joints * 2), np.float32)
        reg = np.zeros((self.max_objs, 2), np.float32)
        ind = np.zeros((self.max_objs,), np.int64)
        reg_mask = np.zeros((self.max_objs,), np.uint8)
        kps_mask = np.zeros((self.max_objs, num_joints * 2), np.uint8)
        hp_offset = np.zeros((self.max_objs * num_joints, 2), np.float32)
        hp_ind = np.zeros((self.max_objs * num_joints,), np.int64)
        hp_mask = np.zeros((self.max_objs * num_joints,), np.int64)
        opt = self.opt
        draw = gaussian_of(opt)

        gt_det = []
        for k in range(num_objs):
            ann = anns[k]
            bbox = coco_box_to_bbox(ann["bbox"])
            cls_id = int(ann["category_id"]) - 1
            pts = np.array(ann["keypoints"], np.float32).reshape(
                num_joints, 3)
            if flipped:
                bbox[[0, 2]] = width - bbox[[2, 0]] - 1
                pts[:, 0] = width - pts[:, 0] - 1
                for e in self.flip_idx:
                    pts[e[0]], pts[e[1]] = pts[e[1]].copy(), pts[e[0]].copy()
            bbox[:2] = affine_transform(bbox[:2], trans_output)
            bbox[2:] = affine_transform(bbox[2:], trans_output)
            bbox = np.clip(bbox, 0, output_res - 1)
            h, w = bbox[3] - bbox[1], bbox[2] - bbox[0]
            if (h > 0 and w > 0) or (rot != 0):
                # the joints' radius (hp_radius in the reference) is the
                # same: --hm_gauss under --mse_loss, else the object's
                radius = opt.hm_gauss if opt.mse_loss else max(0, int(
                    gaussian_radius((math.ceil(h), math.ceil(w)))))
                ct = np.array([(bbox[0] + bbox[2]) / 2,
                               (bbox[1] + bbox[3]) / 2], dtype=np.float32)
                ct_int = ct.astype(np.int32)
                wh[k] = 1.0 * w, 1.0 * h
                ind[k] = ct_int[1] * output_res + ct_int[0]
                reg[k] = ct - ct_int
                reg_mask[k] = 1
                if pts[:, 2].sum() == 0:
                    hm[ct_int[1], ct_int[0], cls_id] = 0.9999
                    reg_mask[k] = 0
                for j in range(num_joints):
                    if pts[j, 2] > 0:
                        pts[j, :2] = affine_transform(pts[j, :2],
                                                      trans_output_rot)
                        if 0 <= pts[j, 0] < output_res and \
                                0 <= pts[j, 1] < output_res:
                            kps[k, j * 2: j * 2 + 2] = pts[j, :2] - ct_int
                            kps_mask[k, j * 2: j * 2 + 2] = 1
                            pt_int = pts[j, :2].astype(np.int32)
                            hp_offset[k * num_joints + j] = \
                                pts[j, :2] - pt_int
                            hp_ind[k * num_joints + j] = \
                                pt_int[1] * output_res + pt_int[0]
                            hp_mask[k * num_joints + j] = 1
                            if opt.dense_hp:
                                draw_dense_reg(
                                    dense_kps[j],
                                    np.ascontiguousarray(hm[:, :, cls_id]),
                                    ct_int, pts[j, :2] - ct_int, radius,
                                    is_offset=True)
                                draw(dense_kps_mask[j], ct_int, radius)
                            splat(hm_hp, j, pt_int, radius, draw)
                splat(hm, cls_id, ct_int, radius, draw)
                gt_det.append([ct[0] - w / 2, ct[1] - h / 2,
                               ct[0] + w / 2, ct[1] + h / 2, 1]
                              + pts[:, :2].reshape(num_joints * 2).tolist()
                              + [cls_id])
        if rot != 0:
            hm = hm * 0 + 0.9999
            reg_mask *= 0
            kps_mask *= 0
        ret.update(hm=hm, reg_mask=reg_mask, ind=ind, wh=wh, hps=kps,
                   hps_mask=kps_mask)
        if opt.dense_hp:
            # (J, 2, R, R) -> (R, R, 2J), the mask repeated per axis
            dkm = np.repeat(dense_kps_mask[:, None], 2, axis=1)
            ret.update(
                dense_hps=np.ascontiguousarray(dense_kps.reshape(
                    num_joints * 2, output_res, output_res)
                    .transpose(1, 2, 0)),
                dense_hps_mask=np.ascontiguousarray(dkm.reshape(
                    num_joints * 2, output_res, output_res)
                    .transpose(1, 2, 0)))
            del ret["hps"], ret["hps_mask"]
        if self.opt.reg_offset:
            ret["reg"] = reg
        if self.opt.hm_hp:
            ret["hm_hp"] = hm_hp
        if self.opt.reg_hp_offset:
            ret.update(hp_offset=hp_offset, hp_ind=hp_ind, hp_mask=hp_mask)
        if self.opt.debug > 0 or not self.split == "train":
            gt_det = np.array(gt_det, dtype=np.float32) if gt_det \
                else np.zeros((1, 40), dtype=np.float32)
            ret["meta"] = {"c": c, "s": s, "gt_det": gt_det,
                           "img_id": img_id}
        return ret


class DddSampler:
    """KITTI 3D targets (reference sample/ddd.py:28-172): the centre
    heatmap (ignore regions splatted at 0.9999), depth, dimensions, the
    2-bin orientation (bins and residuals), box size and offset. An
    augmented sample (--aug_ddd: scale and shift) keeps reg_mask at 0,
    as the reference does; rot_mask stays 1."""

    # default calibration (KITTI's P2) for an image that carries none
    calib = np.array([[707.0493, 0, 604.0814, 45.75831],
                      [0, 707.0493, 180.5066, -0.3454157],
                      [0, 0, 1.0, 0.004981016]], dtype=np.float32)
    alpha_in_degree = False

    def _convert_alpha(self, alpha):
        return math.radians(alpha + 45) if self.alpha_in_degree else alpha

    def _alpha_to_8(self, alpha):
        """2-bin orientation encoding (reference sample/ddd.py:160-171)."""
        ret = [0, 0, 0, 1, 0, 0, 0, 1]
        if alpha < np.pi / 6.0 or alpha > 5 * np.pi / 6.0:
            r = alpha - (-0.5 * np.pi)
            ret[1] = 1
            ret[2], ret[3] = np.sin(r), np.cos(r)
        if alpha > -np.pi / 6.0 or alpha < -5 * np.pi / 6.0:
            r = alpha - (0.5 * np.pi)
            ret[5] = 1
            ret[6], ret[7] = np.sin(r), np.cos(r)
        return ret

    def get_sample(self, index, rng=None, draw_only=False):
        rng = rng if rng is not None else self._data_rng
        if draw_only:
            # the draws need no frame: its shift scales with it
            if self.split == "train" and rng.random() < self.opt.aug_ddd:
                rng.randn(), rng.randn(), rng.randn()
            return None
        img_id = self.images[index]
        img_info = self.coco.loadImgs(ids=[img_id])[0]
        img_path = os.path.join(self.img_dir, img_info["file_name"])
        img = self.load_image(index)
        calib = np.array(img_info["calib"], dtype=np.float32) \
            if "calib" in img_info else self.calib

        height, width = img.shape[0], img.shape[1]
        c = np.array([width / 2.0, height / 2.0])
        if self.opt.keep_res:
            s = np.array([self.opt.input_w, self.opt.input_h],
                         dtype=np.int32)
        else:
            s = np.array([width, height], dtype=np.int32)

        aug = False
        if self.split == "train" and rng.random() < self.opt.aug_ddd:
            aug = True
            sf, cf = self.opt.scale, self.opt.shift
            s = s * np.clip(rng.randn() * sf + 1, 1 - sf, 1 + sf)
            c[0] += width * np.clip(rng.randn() * cf, -2 * cf, 2 * cf)
            c[1] += height * np.clip(rng.randn() * cf, -2 * cf, 2 * cf)

        input_w, input_h = self.opt.input_w, self.opt.input_h
        trans_input = get_affine_transform(c, s, 0, [input_w, input_h])
        inp_u8 = warp_affine_u8(img, invert_affine(trans_input), input_h,
                                input_w)
        ret = finish_input(self, inp_u8, False, rng)

        num_classes = self.opt.num_classes
        out_w, out_h = self.opt.output_w, self.opt.output_h
        trans_output = get_affine_transform(c, s, 0, [out_w, out_h])

        hm = np.zeros((out_h, out_w, num_classes), dtype=np.float32)
        wh = np.zeros((self.max_objs, 2), dtype=np.float32)
        reg = np.zeros((self.max_objs, 2), dtype=np.float32)
        dep = np.zeros((self.max_objs, 1), dtype=np.float32)
        rotbin = np.zeros((self.max_objs, 2), dtype=np.int64)
        rotres = np.zeros((self.max_objs, 2), dtype=np.float32)
        dim = np.zeros((self.max_objs, 3), dtype=np.float32)
        ind = np.zeros((self.max_objs,), dtype=np.int64)
        reg_mask = np.zeros((self.max_objs,), dtype=np.uint8)
        rot_mask = np.zeros((self.max_objs,), dtype=np.uint8)

        anns = self.coco.loadAnns(self.coco.getAnnIds(imgIds=[img_id]))
        num_objs = min(len(anns), self.max_objs)
        draw = gaussian_of(self.opt)
        gt_det = []
        for k in range(num_objs):
            ann = anns[k]
            bbox = coco_box_to_bbox(ann["bbox"])
            cls_id = int(self.cat_ids[ann["category_id"]])
            if cls_id <= -99:
                continue
            bbox[:2] = affine_transform(bbox[:2], trans_output)
            bbox[2:] = affine_transform(bbox[2:], trans_output)
            bbox[[0, 2]] = np.clip(bbox[[0, 2]], 0, out_w - 1)
            bbox[[1, 3]] = np.clip(bbox[[1, 3]], 0, out_h - 1)
            h, w = bbox[3] - bbox[1], bbox[2] - bbox[0]
            if not (h > 0 and w > 0):
                continue
            radius = max(0, int(gaussian_radius((h, w))))
            ct = np.array([(bbox[0] + bbox[2]) / 2,
                           (bbox[1] + bbox[3]) / 2], dtype=np.float32)
            ct_int = ct.astype(np.int32)
            if cls_id < 0:
                # an ignore region: near 1, so the focal loss mutes it
                # (reference sample/ddd.py:108-118)
                ignore_id = list(range(num_classes)) if cls_id == -1 \
                    else [-cls_id - 2]
                if self.opt.rect_mask:
                    hm[int(bbox[1]):int(bbox[3]) + 1,
                       int(bbox[0]):int(bbox[2]) + 1, ignore_id] = 0.9999
                else:
                    for cc in ignore_id:
                        splat(hm, cc, ct, radius, draw)
                    hm[ct_int[1], ct_int[0], ignore_id] = 0.9999
                continue
            splat(hm, cls_id, ct, radius, draw)

            wh[k] = 1.0 * w, 1.0 * h
            gt_det.append(
                [ct[0], ct[1], 1]
                + self._alpha_to_8(self._convert_alpha(ann["alpha"]))
                + [ann["depth"]] + list(np.array(ann["dim"])) + [cls_id])
            if self.opt.reg_bbox:
                gt_det[-1] = gt_det[-1][:-1] + [w, h] + [gt_det[-1][-1]]
            alpha = self._convert_alpha(ann["alpha"])
            if alpha < np.pi / 6.0 or alpha > 5 * np.pi / 6.0:
                rotbin[k, 0] = 1
                rotres[k, 0] = alpha - (-0.5 * np.pi)
            if alpha > -np.pi / 6.0 or alpha < -5 * np.pi / 6.0:
                rotbin[k, 1] = 1
                rotres[k, 1] = alpha - (0.5 * np.pi)
            dep[k] = ann["depth"]
            dim[k] = ann["dim"]
            ind[k] = ct_int[1] * out_w + ct_int[0]
            reg[k] = ct - ct_int
            reg_mask[k] = 1 if not aug else 0
            rot_mask[k] = 1

        ret.update(hm=hm, dep=dep, dim=dim, ind=ind, rotbin=rotbin,
                   rotres=rotres, reg_mask=reg_mask, rot_mask=rot_mask)
        if self.opt.reg_bbox:
            ret["wh"] = wh
        if self.opt.reg_offset:
            ret["reg"] = reg
        if self.opt.debug > 0 or "train" not in self.split:
            gt_det = np.array(gt_det, dtype=np.float32) if gt_det \
                else np.zeros((1, 18), dtype=np.float32)
            ret["meta"] = {"c": c, "s": s, "gt_det": gt_det, "calib": calib,
                           "image_path": img_path, "img_id": img_id}
        return ret


class ExdetSampler:
    """ExtremeNet targets (reference sample/exdet.py:31-140): the four
    extreme-point heatmaps (one channel each with --agnostic_ex) and the
    centre heatmap, dense, with each point's sub-pixel offset and flat
    index. Annotations carry 'extreme_points' (instances_extreme_*.json)."""

    def get_sample(self, index, rng=None, draw_only=False):
        rng = rng if rng is not None else self._data_rng
        img_id = self.images[index]
        if draw_only:
            img = None
            height, width = frame_dims(self, index)
        else:
            img = self.load_image(index)
            height, width = img.shape[0], img.shape[1]
        c = np.array([width / 2.0, height / 2.0])
        s = max(height, width) * 1.0

        flipped = False
        if self.split == "train":
            if not self.opt.not_rand_crop:
                s = s * rng.choice(np.arange(0.6, 1.4, 0.1))
                w_border = get_border(128, width)
                h_border = get_border(128, height)
                c[0] = rng.randint(low=w_border, high=width - w_border)
                c[1] = rng.randint(low=h_border, high=height - h_border)
            else:
                sf, cf = self.opt.scale, self.opt.shift
                s = s * np.clip(rng.randn() * sf + 1, 1 - sf, 1 + sf)
                c[0] += width * np.clip(rng.randn() * cf, -2 * cf, 2 * cf)
                c[1] += height * np.clip(rng.randn() * cf, -2 * cf, 2 * cf)
            if rng.random() < self.opt.flip:
                flipped = True
                if img is not None:
                    img = img[:, ::-1, :]

        if draw_only:
            draw_input_aug(self, self.split == "train", rng)
            return None
        input_res = self.opt.input_res
        trans_input = get_affine_transform(c, s, 0, [input_res, input_res])
        inp_u8 = warp_affine_u8(img, invert_affine(trans_input), input_res,
                                input_res)
        ret = finish_input(self, inp_u8, self.split == "train", rng)

        output_res = self.opt.output_res
        num_classes = self.opt.num_classes
        trans_output = get_affine_transform(c, s, 0, [output_res, output_res])
        num_hm = 1 if self.opt.agnostic_ex else num_classes
        parts = ("t", "l", "b", "r")
        hms = {p: np.zeros((output_res, output_res, num_hm), np.float32)
               for p in parts}
        hm_c = np.zeros((output_res, output_res, num_classes), np.float32)
        regs = {p: np.zeros((self.max_objs, 2), np.float32) for p in parts}
        inds = {p: np.zeros((self.max_objs,), np.int64) for p in parts}
        reg_mask = np.zeros((self.max_objs,), np.uint8)

        anns = self.coco.loadAnns(self.coco.getAnnIds(imgIds=[img_id]))
        num_objs = min(len(anns), self.max_objs)
        draw = gaussian_of(self.opt)
        for k in range(num_objs):
            ann = anns[k]
            pts = np.array(ann["extreme_points"],
                           dtype=np.float32).reshape(4, 2)  # t, l, b, r
            cls_id = int(self.cat_ids[ann["category_id"]])
            hm_id = 0 if self.opt.agnostic_ex else cls_id
            if flipped:
                pts[:, 0] = width - pts[:, 0] - 1
                pts[1], pts[3] = pts[3].copy(), pts[1].copy()
            for j in range(4):
                pts[j] = affine_transform(pts[j], trans_output)
            pts = np.clip(pts, 0, output_res - 1)
            h, w = pts[2, 1] - pts[0, 1], pts[3, 0] - pts[1, 0]
            if h > 0 and w > 0:
                radius = max(0, int(gaussian_radius(
                    (math.ceil(h), math.ceil(w)))))
                pt_int = pts.astype(np.int32)
                for pi, p in enumerate(parts):
                    splat(hms[p], hm_id, pt_int[pi], radius, draw)
                    regs[p][k] = pts[pi] - pt_int[pi]
                    inds[p][k] = pt_int[pi, 1] * output_res + pt_int[pi, 0]
                ct = [int((pts[3, 0] + pts[1, 0]) / 2),
                      int((pts[0, 1] + pts[2, 1]) / 2)]
                splat(hm_c, cls_id, ct, radius, draw)
                reg_mask[k] = 1

        ret.update({"hm_" + p: hms[p] for p in parts}, hm_c=hm_c)
        if self.opt.reg_offset:
            ret["reg_mask"] = reg_mask
            for p in parts:
                ret["reg_" + p] = regs[p]
                ret["ind_" + p] = inds[p]
        if self.opt.debug > 0 or not self.split == "train":
            ret["meta"] = {"c": c, "s": s, "img_id": img_id,
                           "gt_det": np.zeros((1, 6), np.float32)}
        return ret
