"""The port's host NMS (codenet_torch/ops/nms.py) against the JAX
package's, on seeded boxes.

Boxes come in clusters (heavy overlaps), with tied scores and scores low
enough that the decay drops rows below the threshold (the tail-discard
swap that shrinks the logical N). Soft-NMS works in place: the whole array
and the keep list must be exactly equal, for methods 0 (hard), 1 (linear)
and 2 (gaussian).

The port's numpy versions equal the JAX package's numpy versions. Its
native route (float32 boxes to csrc/nms.cpp) equals the JAX package's
native module bit for bit in every function, method and layout, and its
own numpy versions bit for bit where they compute the same float32
operations: hard and linear decay, and hard NMS on scores without ties.
The gaussian decay's exp differs: numpy's float32 exp and the C library's
expf round about a third of their results the other way (by one unit in
the last place), so there the native route is held to the numpy one
within 1e-6 of the scores (2e-5 of the merged coordinates' range) with
equal keep lists. Tied scores order differently in hard NMS: the native
version keeps row order among ties, numpy's argsort its own.
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


CASES = [(TN.soft_nms_numpy, JN._soft_nms_numpy, 5),
         (TN.soft_nms_39_numpy, JN._soft_nms_39_numpy, 39),
         (TN.soft_nms_merge_numpy, JN._soft_nms_merge_numpy, 7)]
NATIVE = [(TN.soft_nms, TN.soft_nms_numpy, "soft_nms", 5),
          (TN.soft_nms_39, TN.soft_nms_39_numpy, "soft_nms_39", 39),
          (TN.soft_nms_merge, TN.soft_nms_merge_numpy, "soft_nms_merge", 7)]
KWARGS = ((70, {}), (71, {"Nt": 0.5, "threshold": 0.01}),
          (72, {"sigma": 0.3, "threshold": 0.01}))


@pytest.mark.parametrize("method", [0, 1, 2])
@pytest.mark.parametrize("fn,ref,cols", CASES,
                         ids=["soft_nms", "soft_nms_39", "soft_nms_merge"])
def test_soft_nms_matches_jax(fn, ref, cols, method):
    """In-place result and keep list bit-equal; a threshold of 0.01 makes
    the decay discard rows (the logical N shrinks)."""
    for seed, kwargs in KWARGS:
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
    keep = TN.nms_numpy(dets.copy(), thresh)
    assert keep == JN._nms_numpy(dets.copy(), thresh)
    assert 0 < len(keep) < len(dets)


@pytest.fixture(scope="module")
def jax_native():
    native = JN._get_native()
    if native is None:
        pytest.fail("the JAX package's native NMS did not build")
    return native


@pytest.mark.parametrize("method", [0, 1, 2])
@pytest.mark.parametrize("fn,plain,name,cols", NATIVE,
                         ids=["soft_nms", "soft_nms_39", "soft_nms_merge"])
def test_native_soft_nms_matches_jax_native_and_numpy(
        jax_native, fn, plain, name, cols, method):
    """float32 boxes take csrc/nms.cpp: bit-equal to the JAX package's
    native module; bit-equal to the numpy version for hard and linear
    decay, within one rounding of the gaussian's exp otherwise."""
    for seed, kwargs in KWARGS:
        boxes = _boxes(seed + method, cols=cols)
        a, b, c = boxes.copy(), boxes.copy(), boxes.copy()
        keep = fn(a, method=method, **kwargs)
        assert keep == getattr(jax_native, name)(
            b, method=method, **{k: float(v) for k, v in kwargs.items()})
        np.testing.assert_array_equal(a, b)
        assert keep == plain(c, method=method, **kwargs)
        if method < 2:
            np.testing.assert_array_equal(a, c)
        else:
            np.testing.assert_allclose(a[:, 4], c[:, 4], rtol=0, atol=1e-6)
            span = float(np.abs(c[:, :4]).max())
            np.testing.assert_allclose(a, c, rtol=0, atol=2e-5 * span)


@pytest.mark.parametrize("thresh", [0.3, 0.5, 0.7])
def test_native_nms_matches_jax_native_and_numpy(jax_native, thresh):
    """Hard NMS: the JAX native module's keep list with tied scores, and
    the numpy version's on scores without ties."""
    dets = _boxes(80)
    assert TN.nms(dets.copy(), thresh) == jax_native.nms(dets.copy(), thresh)
    dets[:, 4] = rng(81).permutation(len(dets)) / len(dets) + 0.01
    keep = TN.nms(dets.copy(), thresh)
    assert keep == TN.nms_numpy(dets.copy(), thresh)
    assert keep == jax_native.nms(dets.copy(), thresh)
    assert 0 < len(keep) < len(dets)


def test_native_route_rules(tmp_path, monkeypatch):
    """float32 C-contiguous boxes go native (a float64 array or a strided
    view takes numpy: same keep list); too few columns raise as the JAX
    native module does; a source that does not build raises."""
    boxes = _boxes(90)
    for arr in (boxes.astype(np.float64), boxes[::1, :5][::-1]):
        a = np.array(arr)
        assert TN.soft_nms(arr.copy() if arr.flags["C_CONTIGUOUS"] else arr,
                           method=1) == TN.soft_nms_numpy(a, method=1)
    with pytest.raises(ValueError):
        TN.soft_nms_39(boxes.copy())
    with pytest.raises(ValueError):
        TN.soft_nms_merge(boxes.copy())
    bad = tmp_path / "nms.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(TN, "SOURCE", bad)
    monkeypatch.setattr(TN, "_lib", None)
    monkeypatch.setattr(TN, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="nms.cpp failed"):
        TN.soft_nms(boxes.copy())
