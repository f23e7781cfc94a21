"""Device-resident image cache (--device_cache; the JAX package's
data/device_cache.py).

The raw frames of a dataset split are padded into one (N, Hmax, Wmax, 3)
uint8 stack and copied to the card once. Per train step the host then
ships only, per sample:

  img_idx  ()      int32  the row of the stack
  warp_ti  (2, 3)  f32    model-input px -> raw-image px affine (the random
                          crop and scale, and the horizontal flip, folded in)

beside the 7 floats of colour-aug state and the sparse targets. The step
warps the rows on the card (data/affine.py::warp_affine_batch, zero
border; the pad is zero, so sampling past a frame's extent reads what
cv2's constant border gives) and runs the device colour aug and
normalisation (data/device_aug.py::model_input). The sampler draws the
same crop, scale, flip and colour stream as the host path; only the
interpolation moves, and the warped pixels are not rounded to uint8.

Batched eval (cli/test.py --device_cache) holds its split the same way.

--device_cache_shard splits the stack's rows over the ranks of a
data-parallel run: rank r's card holds rows [r * rps, (r + 1) * rps) of
the stack padded to a multiple of the world size (rps = ceil(N / world);
the tail shard zero-padded), the layout of the JAX package's
`to_device(shard=True)` over its data mesh, and the loader routes each
rank's rows of every batch to its shard (`shard_ranges`).
"""

from __future__ import annotations

import numpy as np
import torch


def flip_compose(trans_inv, width):
    """Fold a horizontal flip into an output-px -> raw-px affine.

    The host path flips the pixels (img[:, ::-1]) and warps the flipped
    frame, so `trans_inv` lands in flipped coordinates x_f; the cached
    frame is not flipped, so compose with x_raw = (width - 1) - x_f
    (reference sample/ctdet.py:57)."""
    out = np.asarray(trans_inv, np.float32).copy()
    out[0, :] = -out[0, :]
    out[0, 2] += width - 1
    return out


class ImageCache:
    """Padded uint8 stack of every image of a dataset split."""

    def __init__(self, images_u8, dims):
        self.images = images_u8          # (N, Hmax, Wmax, 3) uint8
        self.dims = dims                 # (N, 2) int32 (h, w)
        self.nbytes = images_u8.nbytes   # kept after to_device drops images

    @classmethod
    def build(cls, dataset):
        """Read every image of `dataset` once, through its `load_image`
        (the reader of the host path).

        The stack is allocated up front from the annotations' (height,
        width) records where they exist, so the build holds one decoded
        image at a time. A frame larger than the records (EXIF rotation,
        stale records) falls back to the two-pass build; decoded dims win
        over the records."""
        n = len(dataset)
        meta = _metadata_dims(dataset)
        if meta is None:
            return cls._build_two_pass(dataset)
        dims = np.zeros((n, 2), np.int32)
        hmax, wmax = int(meta[:, 0].max()), int(meta[:, 1].max())
        stack = np.zeros((n, hmax, wmax, 3), np.uint8)
        warned = False
        for i in range(n):
            img = dataset.load_image(i)
            h, w = img.shape[0], img.shape[1]
            if h > hmax or w > wmax:
                print("device_cache: image {} decodes {}x{}, past the "
                      "metadata extent {}x{}; rebuilding via the two-pass "
                      "path".format(i, h, w, hmax, wmax))
                return cls._build_two_pass(dataset)
            if not warned and (h, w) != (int(meta[i, 0]), int(meta[i, 1])):
                print("device_cache: image {} is {}x{} on disk but the "
                      "annotations say {}x{}; using decoded dims".format(
                          i, h, w, int(meta[i, 0]), int(meta[i, 1])))
                warned = True
            dims[i] = h, w
            stack[i, :h, :w] = img
        return cls(stack, dims)

    @classmethod
    def _build_two_pass(cls, dataset):
        n = len(dataset)
        dims = np.zeros((n, 2), np.int32)
        raws = []
        for i in range(n):
            img = dataset.load_image(i)
            dims[i] = img.shape[0], img.shape[1]
            raws.append(img)
        stack = np.zeros((n, int(dims[:, 0].max()), int(dims[:, 1].max()),
                          3), np.uint8)
        for i in range(n):
            stack[i, :raws[i].shape[0], :raws[i].shape[1]] = raws[i]
            raws[i] = None  # free as we go: peak ~1x the stack, not 2x
        return cls(stack, dims)

    def to_device(self, device="cuda", shard=False, dp=None):
        """Copy the stack to `device`; returns the tensor and drops the
        host copy (`images` becomes None; `nbytes` and `dims` stay).

        shard=True: only the rows of rank dp.rank of dp.world (one rank
        without `dp`), rps = ceil(N / world) of them, the tail shard
        zero-padded; sets `shard_rows` (rps) and `shard_ranges` (each
        shard's (lo, hi) real rows, for DataLoader(shard_ranges=...)).
        A dataset with fewer images than ranks raises. Warns when the
        copy takes more than half the card's memory."""
        device = torch.device(device)
        n = self.images.shape[0]
        host = self.images
        if shard:
            rank, world = (dp.rank, dp.world) if dp is not None else (0, 1)
            if n < world:
                raise ValueError(
                    "--device_cache_shard: dataset ({} images) is smaller "
                    "than the data-parallel group ({} ranks)".format(
                        n, world))
            rps = -(-n // world)
            self.shard_rows = rps
            self.shard_ranges = [(min(s * rps, n), min((s + 1) * rps, n))
                                 for s in range(world)]
            lo, hi = self.shard_ranges[rank]
            host = self.images[lo:hi]
            if hi - lo < rps:
                host = np.zeros((rps,) + host.shape[1:], np.uint8)
                host[:hi - lo] = self.images[lo:hi]
        if device.type == "cuda":
            total = torch.cuda.get_device_properties(device).total_memory
            if host.nbytes > total / 2:
                print("WARNING: device_cache {} is {:.1f} GB ({} x 3 uint8), "
                      "more than half of the card's {:.1f} GB; consider "
                      "dropping --device_cache".format(
                          "shard" if shard else "stack", host.nbytes / 1e9,
                          " x ".join(map(str, host.shape[:3])),
                          total / 1e9))
        out = torch.from_numpy(np.ascontiguousarray(host)).to(device)
        self.images = None
        return out


def _metadata_dims(dataset):
    """(N, 2) (h, w) from the dataset's annotation records, or None."""
    coco = getattr(dataset, "coco", None)
    images = getattr(dataset, "images", None)
    if coco is None or images is None:
        return None
    try:
        infos = coco.loadImgs(ids=list(images))
        return np.asarray([[int(i["height"]), int(i["width"])]
                           for i in infos], np.int32)
    except (KeyError, TypeError):
        return None
