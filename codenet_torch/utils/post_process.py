"""Host post-processing of ctdet, multi_pose and ddd detections (the JAX
package's utils/post_process.py:17-118; reference lib/utils/
post_process.py). The ctdet detector back-projects on the device
(models/decode.py::backproject_dets); `ctdet_post_process` serves the
trainer's --test results (engine/train_hooks.py)."""

from __future__ import annotations

import numpy as np

from ..data.affine import transform_preds
from .ddd_utils import ddd2locrot


def get_pred_depth(depth):
    return depth


def get_alpha(rot):
    """The 2-bin orientation head (n, 8) -> alpha (reference
    post_process.py:14-21): bin 1 or 2 by its logit, then atan2 of its
    sin/cos residual, offset by -pi/2 or +pi/2."""
    idx = rot[:, 1] > rot[:, 5]
    alpha1 = np.arctan2(rot[:, 2], rot[:, 3]) + (-0.5 * np.pi)
    alpha2 = np.arctan2(rot[:, 6], rot[:, 7]) + (0.5 * np.pi)
    return alpha1 * idx + alpha2 * (1 - idx)


def ctdet_post_process(dets, c, s, h, w, num_classes):
    """dets (N, K, 6) output-map ctdet detections [x1 y1 x2 y2 score cls]
    -> per image {class: [[x1, y1, x2, y2, score], ...]} in image pixels
    (reference post_process.py:86-103); `dets` is changed in place."""
    ret = []
    for i in range(dets.shape[0]):
        top_preds = {}
        dets[i, :, :2] = transform_preds(dets[i, :, 0:2], c[i], s[i], (w, h))
        dets[i, :, 2:4] = transform_preds(dets[i, :, 2:4], c[i], s[i],
                                          (w, h))
        classes = dets[i, :, -1]
        for j in range(num_classes):
            inds = classes == j
            top_preds[j + 1] = np.concatenate([
                dets[i, inds, :4].astype(np.float32),
                dets[i, inds, 4:5].astype(np.float32)], axis=1).tolist()
        ret.append(top_preds)
    return ret


def ddd_post_process_2d(dets, c, s, opt):
    """dets (N, K, 18 or 16) output-map ddd detections [xs ys score rot(8)
    depth dim(3) (wh) cls] -> per image {class: (n, 8 or 10)} [x y score
    alpha depth dim(3) (wh)], the centre and wh back in image pixels
    (reference post_process.py:24-48)."""
    ret = []
    include_wh = dets.shape[2] > 16
    for i in range(dets.shape[0]):
        top_preds = {}
        dets[i, :, :2] = transform_preds(
            dets[i, :, 0:2], c[i], s[i], (opt.output_w, opt.output_h))
        classes = dets[i, :, -1]
        for j in range(opt.num_classes):
            inds = classes == j
            top_preds[j + 1] = np.concatenate([
                dets[i, inds, :3].astype(np.float32),
                get_alpha(dets[i, inds, 3:11])[:, np.newaxis].astype(
                    np.float32),
                get_pred_depth(dets[i, inds, 11:12]).astype(np.float32),
                dets[i, inds, 12:15].astype(np.float32)], axis=1)
            if include_wh:
                top_preds[j + 1] = np.concatenate([
                    top_preds[j + 1],
                    transform_preds(dets[i, inds, 15:17], c[i], s[i],
                                    (opt.output_w, opt.output_h)).astype(
                        np.float32)], axis=1)
        ret.append(top_preds)
    return ret


def ddd_post_process_3d(dets, calibs):
    """Per image {class: (n, 14)} [alpha x1 y1 x2 y2 dim(3) location(3)
    rotation_y score]: the 3D location unprojected at the predicted depth
    through the image's calib (reference post_process.py:51-77). The
    first image's calib serves every image, as in the reference."""
    ret = []
    for i in range(len(dets)):
        preds = {}
        for cls_ind in dets[i].keys():
            preds[cls_ind] = []
            for j in range(len(dets[i][cls_ind])):
                center = dets[i][cls_ind][j][:2]
                score = dets[i][cls_ind][j][2]
                alpha = dets[i][cls_ind][j][3]
                depth = dets[i][cls_ind][j][4]
                dimensions = dets[i][cls_ind][j][5:8]
                wh = dets[i][cls_ind][j][8:10]
                locations, rotation_y = ddd2locrot(
                    center, alpha, dimensions, depth, calibs[0])
                bbox = [center[0] - wh[0] / 2, center[1] - wh[1] / 2,
                        center[0] + wh[0] / 2, center[1] + wh[1] / 2]
                pred = [alpha] + bbox + dimensions.tolist() + \
                    locations.tolist() + [rotation_y, score]
                preds[cls_ind].append(pred)
            preds[cls_ind] = np.array(preds[cls_ind], dtype=np.float32)
        ret.append(preds)
    return ret


def ddd_post_process(dets, c, s, calibs, opt):
    return ddd_post_process_3d(ddd_post_process_2d(dets, c, s, opt), calibs)


def multi_pose_post_process(dets, c, s, h, w):
    """dets: (N, K, 40) output-map detections; c, s: per image centre and
    scale of the letterbox; (h, w): the output map. Box corners and the
    17 joints go back to image pixels. Returns per image {1: (K, 39)
    list}: box, score, joints."""
    ret = []
    for i in range(dets.shape[0]):
        bbox = transform_preds(dets[i, :, :4].reshape(-1, 2), c[i], s[i],
                               (w, h))
        pts = transform_preds(dets[i, :, 5:39].reshape(-1, 2), c[i], s[i],
                              (w, h))
        top_preds = np.concatenate(
            [bbox.reshape(-1, 4), dets[i, :, 4:5],
             pts.reshape(-1, 34)], axis=1).astype(np.float32).tolist()
        ret.append({1: top_preds})
    return ret
