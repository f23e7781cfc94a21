"""The one generator of the benchmark's traffic: frames and their
annotations, drawn from a traffic mix's parameters and a seed.

A mix fixes the multiset of frame sizes and of object counts (each size
and count takes its share of the frames, rounded down, the rest going to
the first entry); the seed draws their order, every box and class, and
the pixels. So every seed gives the same amount of work, in another
order, on other pixels.

Pixels are made on the card from a `torch.Generator` seeded from the
seed, in a few large calls: as one padded uint8 stack for a training
cell's image cache (the pad outside each frame zero, as the program's
cache keeps it), or copied once to the host for a serving cell's pool of
raw frames.
"""

from __future__ import annotations

import numpy as np
import torch

CHUNK_ROWS = 1024


def seeds(seed, n):
    """n independent 31-bit seeds derived from `seed` (any whole number)."""
    ss = np.random.SeedSequence(int(seed) % (1 << 128))
    return [int(s) & 0x7FFFFFFF for s in ss.generate_state(n)]


def _shares(table, count):
    """Each entry's count of `count` items: its share rounded down, the
    rest to the first entry."""
    counts = [int(share * count) for *_, share in table]
    counts[0] += count - sum(counts)
    return counts


def frame_sizes(mix, rng):
    """(count, 2) int32 (h, w) of the mix's frames, in the seed's order."""
    count = mix["count"]
    sizes = np.concatenate([
        np.tile(np.asarray([[h, w]], np.int32), (n, 1))
        for (h, w, _), n in zip(mix["sizes"], _shares(mix["sizes"], count))])
    return sizes[rng.permutation(count)]


def annotations(mix, dims, rng, num_classes):
    """COCO-form ground truth of frames of `dims`: ids 1..N, each frame
    with its count of boxes from the mix's `objects` table, each box's
    sides a log-uniform share of the frame's in `box_share`, placed
    uniformly inside it, its class uniform."""
    count = len(dims)
    per = np.concatenate([np.full(n, k, np.int64) for (k, _), n in
                          zip(mix["objects"],
                              _shares(mix["objects"], count))])
    per = per[rng.permutation(count)]
    lo, hi = np.log(mix["box_share"][0]), np.log(mix["box_share"][1])
    images, anns = [], []
    for i, ((h, w), k) in enumerate(zip(dims, per)):
        images.append({"id": i + 1, "height": int(h), "width": int(w),
                       "file_name": "{}.png".format(i + 1)})
        bw = np.exp(rng.uniform(lo, hi, k)) * w
        bh = np.exp(rng.uniform(lo, hi, k)) * h
        x0 = rng.uniform(0, 1, k) * (w - bw)
        y0 = rng.uniform(0, 1, k) * (h - bh)
        cls = rng.randint(1, num_classes + 1, k)
        for j in range(k):
            anns.append({"id": len(anns) + 1, "image_id": i + 1,
                         "category_id": int(cls[j]), "iscrowd": 0,
                         "bbox": [float(x0[j]), float(y0[j]), float(bw[j]),
                                  float(bh[j])],
                         "area": float(bw[j] * bh[j])})
    cats = [{"id": c, "name": str(c)} for c in range(1, num_classes + 1)]
    return {"images": images, "annotations": anns, "categories": cats}


def pixels(dims, seed, device, zero_pad=True):
    """(N, Hmax, Wmax, 3) uint8 noise on `device`, made from `seed` in
    chunks of CHUNK_ROWS frames; with `zero_pad` each frame's pad beyond
    its (h, w) is zero."""
    n = len(dims)
    hmax, wmax = int(dims[:, 0].max()), int(dims[:, 1].max())
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    out = torch.empty((n, hmax, wmax, 3), dtype=torch.uint8, device=device)
    d = torch.as_tensor(dims, device=device).long()
    ys = torch.arange(hmax, device=device)[None, :, None, None]
    xs = torch.arange(wmax, device=device)[None, None, :, None]
    for lo in range(0, n, CHUNK_ROWS):
        hi = min(lo + CHUNK_ROWS, n)
        torch.randint(0, 256, (hi - lo, hmax, wmax, 3), dtype=torch.uint8,
                      device=device, generator=gen, out=out[lo:hi])
        if zero_pad:
            inside = (ys < d[lo:hi, 0, None, None, None]) \
                & (xs < d[lo:hi, 1, None, None, None])
            out[lo:hi].mul_(inside)
    return out


def host_pool(dims, seed, device):
    """The serving pool: a (N, Hmax, Wmax, 3) uint8 host array of noise
    made on `device` and copied to the host once; frame i is
    pool[i, :h, :w]."""
    dev = pixels(dims, seed, device, zero_pad=False)
    host = np.empty(tuple(dev.shape), np.uint8)
    for lo in range(0, len(dims), CHUNK_ROWS):
        host[lo:lo + CHUNK_ROWS] = dev[lo:lo + CHUNK_ROWS].cpu().numpy()
    del dev
    return host
