"""Host post-processing of multi_pose detections (the JAX package's
utils/post_process.py:105-118; reference lib/utils/post_process.py:
106-117). ctdet back-projects on the device (models/decode.py::
backproject_dets)."""

from __future__ import annotations

import numpy as np

from ..data.affine import transform_preds


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
