"""The port's host NMS (codenet_torch/ops/nms.py) against the JAX
package's numpy versions, on seeded boxes.

Boxes come in clusters (heavy overlaps), with tied scores and scores low
enough that the decay drops rows below the threshold (the tail-discard
swap that shrinks the logical N). Soft-NMS works in place: the whole array
and the keep list must be exactly equal, for methods 0 (hard), 1 (linear)
and 2 (gaussian).
"""

import numpy as np
import pytest

from test_torch_common import rng

from codenet_tpu.ops import nms as JN
from codenet_torch.ops import nms as TN


def _boxes(seed, n=60, cols=5):
    """n boxes in 6 clusters; scores in [0.002, 1) rounded to 2 decimals
    (ties) with a fifth of them at 0.002-0.02 (tail discards)."""
    r = rng(seed)
    centres = r.uniform(20, 180, (6, 2))[r.randint(0, 6, n)]
    xy = centres + r.randn(n, 2) * 6
    wh = r.uniform(10, 40, (n, 2))
    scores = np.round(r.uniform(0.0, 1.0, n), 2)
    low = r.rand(n) < 0.2
    scores[low] = r.uniform(0.002, 0.02, low.sum())
    out = np.concatenate([xy, xy + wh, scores[:, None]], axis=1)
    if cols == 7:
        out = np.concatenate([out, r.uniform(0.1, 1.0, (n, 2))], axis=1)
    elif cols == 39:
        out = np.concatenate([out, r.uniform(0, 200, (n, 34))], axis=1)
    return out.astype(np.float32)


CASES = [(TN.soft_nms, JN._soft_nms_numpy, 5),
         (TN.soft_nms_39, JN._soft_nms_39_numpy, 39),
         (TN.soft_nms_merge, JN._soft_nms_merge_numpy, 7)]


@pytest.mark.parametrize("method", [0, 1, 2])
@pytest.mark.parametrize("fn,ref,cols", CASES,
                         ids=["soft_nms", "soft_nms_39", "soft_nms_merge"])
def test_soft_nms_matches_jax(fn, ref, cols, method):
    """In-place result and keep list bit-equal; a threshold of 0.01 makes
    the decay discard rows (the logical N shrinks)."""
    for seed, kwargs in ((70, {}), (71, {"Nt": 0.5, "threshold": 0.01}),
                         (72, {"sigma": 0.3, "threshold": 0.01})):
        boxes = _boxes(seed + method, cols=cols)
        a, b = boxes.copy(), boxes.copy()
        keep_ref = ref(a, method=method, **kwargs)
        keep = fn(b, method=method, **kwargs)
        assert keep == keep_ref
        np.testing.assert_array_equal(b, a)
        if kwargs:
            assert len(keep) < len(boxes), "no tail discard exercised"


@pytest.mark.parametrize("thresh", [0.3, 0.5, 0.7])
def test_nms_matches_jax(thresh):
    dets = _boxes(80)
    keep = TN.nms(dets.copy(), thresh)
    assert keep == JN._nms_numpy(dets.copy(), thresh)
    assert 0 < len(keep) < len(dets)
