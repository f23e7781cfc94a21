#!/usr/bin/env python
"""Time the port's PNG reader against cv2.imread on a KITTI-size frame.

A 375 x 1242 BGR frame (a smooth gradient with noise, as a camera frame
is) is written by cv2 (libpng) once per scanline filter setting: each of
the five filter types alone, libpng's adaptive choice among all five
(ALL) and cv2's default. Each file is read `--repeat` times with
codenet_torch/data/image_io.py's `read_png` and with `cv2.imread`; the
median times and whether the pixels agree are printed as one JSON line.
Needs cv2; runs on any host:

  python tools_torch/png_read_time.py [--repeat 5] [--dir DIR]
"""

import argparse
import json
import os
import sys
import tempfile
import time
import zlib

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
from codenet_torch.data.image_io import _chunks, read_png  # noqa: E402

# cv2's name of each filter setting (None: cv2's default)
FILTERS = {"NONE": "IMWRITE_PNG_FILTER_NONE",
           "SUB": "IMWRITE_PNG_FILTER_SUB", "UP": "IMWRITE_PNG_FILTER_UP",
           "AVG": "IMWRITE_PNG_FILTER_AVG",
           "PAETH": "IMWRITE_PNG_FILTER_PAETH",
           "ALL": "IMWRITE_PNG_ALL_FILTERS", "default": None}


def kitti_frame(seed=0, height=375, width=1242):
    r = np.random.RandomState(seed)
    y, x = np.mgrid[0:height, 0:width]
    img = np.stack([(x * 0.2 + y * 0.3) % 256, (x * 0.05) % 256,
                    (y * 0.6) % 256], -1)
    return (img + r.randint(0, 20, img.shape)).astype(np.uint8)


def filter_counts(path, height, stride):
    """{filter type: scanlines} of a PNG file."""
    with open(path, "rb") as f:
        data = f.read()
    raw = zlib.decompress(b"".join(p for t, p in _chunks(data, path)
                                   if t == b"IDAT"))
    kinds = np.frombuffer(raw, np.uint8)[::stride + 1][:height]
    return {int(k): int(n) for k, n in zip(*np.unique(kinds,
                                                     return_counts=True))}


def _median_ms(fn, repeat):
    times = []
    for _ in range(repeat):
        t0 = time.perf_counter()
        out = fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times)), out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--repeat", type=int, default=5)
    ap.add_argument("--dir", default=None,
                    help="where the frames are written (a temporary "
                         "directory by default)")
    args = ap.parse_args(argv)
    import cv2
    img = kitti_frame()
    out = {"frame": list(img.shape), "cv2": cv2.__version__}
    with tempfile.TemporaryDirectory(dir=args.dir) as tmp:
        for name, flag in FILTERS.items():
            if flag is not None and not hasattr(cv2, flag):
                out[name] = "not in this cv2"
                continue
            path = os.path.join(tmp, name + ".png")
            params = [] if flag is None else [cv2.IMWRITE_PNG_FILTER,
                                              getattr(cv2, flag)]
            cv2.imwrite(path, img, params)
            ours_ms, ours = _median_ms(lambda: read_png(path), args.repeat)
            cv2_ms, ref = _median_ms(lambda: cv2.imread(path), args.repeat)
            out[name] = {"read_png_ms": ours_ms, "cv2_ms": cv2_ms,
                         "equal": bool(np.array_equal(ours, ref)),
                         "filters": filter_counts(path, img.shape[0],
                                                  img.shape[1] * 3)}
    print(json.dumps(out), flush=True)
    return 0 if all(v["equal"] for v in out.values()
                    if isinstance(v, dict)) else 1


if __name__ == "__main__":
    sys.exit(main())
