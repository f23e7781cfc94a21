"""Oracle (ground-truth substitution) maps for the --eval_oracle_* probes
(the JAX package's utils/oracle.py; reference lib/utils/oracle_utils.py).

The reference fills every position with the feature of its nearest
ground-truth point by a numba BFS (L1 metric). As in the JAX package,
scipy's exact euclidean distance transform with return_indices gives the
same nearest-point fill without numba (equidistant ties may pick another
point, which the probe does not care about). Host numpy, output NHWC.
"""

from __future__ import annotations

import numpy as np


def gen_oracle_map(feat, ind, w, h):
    """feat: (B, maxN, C); ind: (B, maxN) flat y*w+x. Returns (B, h, w, C)
    f32: each position the feature of its nearest point with ind > 0."""
    from scipy import ndimage
    feat = np.asarray(feat)
    ind = np.asarray(ind)
    b, max_objs, c = feat.shape
    out = np.zeros((b, h, w, c), dtype=np.float32)
    for i in range(b):
        seeded = np.zeros((h, w), dtype=bool)
        seed_feat = np.zeros((h, w, c), dtype=np.float32)
        for j in range(max_objs):
            if ind[i][j] > 0:
                x, y = int(ind[i][j] % w), int(ind[i][j] // w)
                seed_feat[y, x] = feat[i][j]
                seeded[y, x] = True
        if not seeded.any():
            continue
        _, (iy, ix) = ndimage.distance_transform_edt(
            ~seeded, return_indices=True)
        out[i] = seed_feat[iy, ix]
    return out
