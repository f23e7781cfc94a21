"""The readings of the tiny ShuffleNetV2 fixture are bit for bit those of
the harness before its architectures became modules: the seeded state
and its calibrated statistics (FP32 and W4A8), the reference's first
three training steps (losses, Adam's first gradients, the weights after)
on the rows and batches a run took, and the served dense maps of one
request. The digests were recorded on the tree before the move, with one
CPU thread (the CPU's reductions are ordered by the thread count)."""

import hashlib
import struct

import numpy as np
import pytest
import torch

from benchmark.harness import cell as C
from benchmark.harness import probe, traffic, train, weights
from benchmark.reference.serve import dense_detections

from . import tiny

SEED = 2 ** 31 + 2 ** 30 + 17
QUANT = {"w_bit": 4, "a_bit": 8, "wt_percentile": True, "act_clamp": True}
DIGESTS = {"make_f32": "a0d1423c8de1f9b4",
           "calibrated_f32": "4d1847d7fa93c148",
           "make_qat": "222ea8e1e4628f86",
           "calibrated_qat": "2ae9449d9368d41b",
           "losses": "a0c15ba873791f76", "first_grads": "7a06b6773c7a97e9",
           "after": "501618fa04633d68", "serve_state": "a6020e20dde07293",
           "dense": "b0d9693cec462fd6"}


def digest(obj):
    """The first 16 hex digits of a SHA-256 over dicts (by sorted key),
    sequences, tensors (dtype, shape and bytes) and floats (f64)."""
    h = hashlib.sha256()

    def put(x):
        if isinstance(x, dict):
            for k in sorted(x):
                h.update(k.encode())
                put(x[k])
        elif isinstance(x, (list, tuple)):
            for v in x:
                put(v)
        elif isinstance(x, torch.Tensor):
            h.update(str(x.dtype).encode() + str(tuple(x.shape)).encode())
            h.update(x.detach().cpu().contiguous().numpy().tobytes())
        elif isinstance(x, float):
            h.update(struct.pack("<d", x))
        else:
            h.update(repr(x).encode())
    put(obj)
    return h.hexdigest()[:16]


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield tiny.make(tmp_path_factory.mktemp("bench"))
    finally:
        torch.set_num_threads(threads)


@pytest.mark.parametrize("quant", [False, True], ids=["f32", "qat"])
def test_seeded_and_calibrated_state(root, quant):
    cell = C.Cell("tiny_train", root=root)
    frames = torch.randint(0, 256, (4, 60, 64, 3), dtype=torch.uint8,
                           generator=torch.Generator().manual_seed(5))
    p, b = weights.make(cell.arch, cell.config, 7, "cpu", quant)
    kind = "qat" if quant else "f32"
    assert digest([p, b]) == DIGESTS["make_" + kind]
    b = weights.calibrated(cell.arch, cell.config, p, b, frames,
                           np.array([[60, 64]] * 4), QUANT if quant else None)
    assert digest(b) == DIGESTS["calibrated_" + kind]


def test_reference_training_steps(root):
    cell = C.Cell("tiny_train", root=root)
    rec = C.run(cell, SEED, 0.5, False, "cpu", probe.Spans())
    params, buffers, rows, first = rec["inputs"]
    ref = train.reference_steps(cell, params, buffers, rows, first)
    got = {k: digest(ref[k]) for k in ("losses", "first_grads", "after")}
    assert got == {k: DIGESTS[k] for k in got}


def test_served_dense_maps_of_a_request(root):
    """As harness/serve.py seeds a run and orders its first request."""
    cell = C.Cell("tiny_serve", root=root)
    wl = cell.workload
    data_seed, weight_seed, order_seed = traffic.seeds(SEED, 3)
    dims = traffic.frame_sizes(wl["frames"], np.random.RandomState(data_seed))
    pool = traffic.host_pool(dims, data_seed, "cpu")
    params, buffers = weights.make(cell.arch, cell.config, weight_seed, "cpu")
    buffers = weights.calibrated(cell.arch, cell.config, params, buffers,
                                 torch.as_tensor(pool[:8]), dims[:8])
    order = np.random.RandomState(order_seed).permutation(len(dims))
    frames = [pool[i, :dims[i, 0], :dims[i, 1]]
              for i in order[:wl["batch"]]]
    dense = dense_detections(cell.arch, frames, cell.config, params, buffers,
                             wl["K"])
    assert digest([params, buffers]) == DIGESTS["serve_state"]
    assert digest(list(dense._asdict().values())) == DIGESTS["dense"]
