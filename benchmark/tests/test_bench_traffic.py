"""The traffic generator and the yardstick's counts."""

import numpy as np
import pytest
import torch

from benchmark import counts
from benchmark.harness import cell as C
from benchmark.harness import traffic

MIXES = sorted(p.stem for p in (C.BENCH / "traffic").glob("*.json"))


def _mix(name):
    return dict(C.traffic_mix(C.BENCH, name)["frames"], count=97)


@pytest.mark.parametrize("name", MIXES)
def test_same_seed_same_traffic_other_seed_same_work(name):
    mix = _mix(name)

    def draw(seed):
        d, w, _ = traffic.seeds(seed, 3)
        rng = np.random.RandomState(d)
        dims = traffic.frame_sizes(mix, rng)
        gt = traffic.annotations(mix, dims, rng, 20)
        return dims, gt, traffic.pixels(dims[:3], d, "cpu")
    big = 2 ** 31 + 7
    a, b, c = draw(big), draw(big), draw(big + 1)
    assert (a[0] == b[0]).all() and a[1] == b[1]
    assert torch.equal(a[2], b[2])
    # another seed: the same multiset of sizes and of object counts, in
    # another order, on other pixels
    assert not (a[0] == c[0]).all()
    assert sorted(map(tuple, a[0])) == sorted(map(tuple, c[0]))

    def per_frame(gt):
        n = np.zeros(len(gt["images"]), int)
        for ann in gt["annotations"]:
            n[ann["image_id"] - 1] += 1
        return sorted(n)
    assert per_frame(a[1]) == per_frame(c[1])
    assert not torch.equal(a[2], c[2])


def test_pixels_zero_beyond_each_frame():
    dims = np.array([[5, 7], [7, 4]], np.int32)
    px = traffic.pixels(dims, 3, "cpu")
    assert px.shape == (2, 7, 7, 3)
    assert not px[0, 5:].any() and not px[1, :, 4:].any()
    assert px[0, :5, :7].any()


def test_shares_round_down_with_the_rest_first():
    table = [[1, 0.5], [2, 0.3], [3, 0.2]]
    assert traffic._shares(table, 11) == [6, 3, 2]


def test_deform_counts_at_one_shape():
    # n 2, 4 x 4 map, 8 channels, f32: x read, out written (2 * 2*16*8*4),
    # s read (2*16*4), the weight (9*8*4)
    assert counts.deform_fwd_bytes(2, 4, 4, 8) == 2048 + 128 + 288
    # x, g read and dx written (3 * 1024), s read and ds written (2 * 128),
    # dw read and written (2 * 288)
    assert counts.deform_bwd_bytes(2, 4, 4, 8) == 3072 + 256 + 576
    assert counts.BWD_FLOPS_PER_ELEM == 251
    assert counts.deform_maps(512, True) == [(16, 16, 2153), (32, 32, 256),
                                              (64, 64, 128)]
    # the forward bound of one call at batch 64, 16x16x2153: bytes bound
    elems = 64 * 16 * 16 * 2153
    want = (8 * elems + 64 * 256 * 4 + 9 * 2153 * 4) / 3.35e12
    assert counts.deform_fwd_bound_s(64, [(16, 16, 2153)]) == \
        pytest.approx(want, rel=1e-12)
    assert elems * 90 / 67e12 < want
