"""KITTI 3D detection scoring: label parsing and the ctypes bridge to the
host C++ scorer (`codenet_torch/csrc/kitti_eval.cpp`).

The port's own copy of the JAX package's eval/kitti_eval.py, which
replaces the reference's shell-out to the prebuilt
tools/kitti_eval/evaluate_object_3d_offline binary
(lib/datasets/dataset/kitti.py:84-88). It reads KITTI-format txt files:

    type trunc occ alpha x1 y1 x2 y2 h w l tx ty tz ry [score]

and reports per class and difficulty the AP of 2D boxes, AOS, bird's-eye
and 3D boxes: 11-point sampling (every 4th) of the 41-recall-point
interpolated precision curve, as the reference binary prints them.

The scorer is built with the host C++ compiler on first use into
`codenet_torch/_build/libkitti_eval_<source hash>.so` and loaded with
ctypes; a failed build raises (there is no other scorer to fall back to).
"""

from __future__ import annotations

import ctypes
import os
import sys
import threading
from pathlib import Path

import numpy as np

from ..utils import cxx

CLASSES = {"car": 0, "pedestrian": 1, "cyclist": 2,
           # neighbour classes ignored for the main class (official rules)
           "van": -2, "person_sitting": -3, "dontcare": -1}
CLASS_NAMES = ["Car", "Pedestrian", "Cyclist"]
DIFFICULTY = ["easy", "moderate", "hard"]

_RECORD = 16
_PKG = Path(__file__).resolve().parent.parent
SOURCE = _PKG / "csrc" / "kitti_eval.cpp"
BUILD_DIR = cxx.BUILD_DIR

_lib = None
_lib_lock = threading.Lock()


def library_path():
    """Where the scorer built from SOURCE lives."""
    return cxx.library_path(SOURCE, "kitti_eval", BUILD_DIR)


def build():
    """Compile the scorer into BUILD_DIR once per source hash
    (utils/cxx.py); returns the library's path."""
    return cxx.build_shared(SOURCE, "kitti_eval", BUILD_DIR)


def _get_lib():
    global _lib
    with _lib_lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            lib.kitti_evaluate.restype = ctypes.c_int
            lib.kitti_evaluate.argtypes = [
                ctypes.POINTER(ctypes.c_double),
                ctypes.POINTER(ctypes.c_long),
                ctypes.POINTER(ctypes.c_double),
                ctypes.POINTER(ctypes.c_long), ctypes.c_long,
                ctypes.POINTER(ctypes.c_double),
                ctypes.POINTER(ctypes.c_double)]
            _lib = lib
    return _lib


def parse_label_file(path, is_gt):
    """One KITTI txt -> (M, 16) float64 records [cls x1 y1 x2 y2 h w l tx
    ty tz ry alpha score occ trunc]."""
    rows = []
    if not os.path.exists(path):
        return np.zeros((0, _RECORD))
    with open(path) as f:
        for line in f:
            parts = line.strip().split(" ")
            if len(parts) < 15:
                continue
            cls = CLASSES.get(parts[0].lower(), 99)
            trunc = float(parts[1])
            occ = float(parts[2])
            alpha = float(parts[3])
            x1, y1, x2, y2 = map(float, parts[4:8])
            h, w, l = map(float, parts[8:11])
            tx, ty, tz = map(float, parts[11:14])
            ry = float(parts[14])
            score = float(parts[15]) if len(parts) > 15 else 1.0
            rows.append([cls, x1, y1, x2, y2, h, w, l, tx, ty, tz, ry,
                         alpha, score, occ, trunc])
    return np.array(rows, dtype=np.float64).reshape(-1, _RECORD)


def evaluate_records(gts_per_image, dets_per_image, return_curves=False):
    """gts/dets: lists of (M_i, 16) float64 arrays, one per image. Returns
    {"<Class>_<difficulty>": {"AP2D", "AOS", "AP_BEV", "AP_3D"}}, with
    `return_curves` also the 41-point precision curves ("curves": {"p2d",
    "aos", "p_bev", "p_3d"}) the reference binary writes to plot/*.txt."""
    n = len(gts_per_image)
    gt_counts = np.array([len(g) for g in gts_per_image], dtype=np.int64)
    det_counts = np.array([len(d) for d in dets_per_image], dtype=np.int64)
    gt_data = np.ascontiguousarray(
        np.concatenate([g.reshape(-1, _RECORD) for g in gts_per_image])
        if gt_counts.sum() else np.zeros((0, _RECORD)))
    det_data = np.ascontiguousarray(
        np.concatenate([d.reshape(-1, _RECORD) for d in dets_per_image])
        if det_counts.sum() else np.zeros((0, _RECORD)))
    results = np.zeros(36, dtype=np.float64)
    curves = np.zeros((3, 3, 4, 41), dtype=np.float64)
    lib = _get_lib()
    cdp = ctypes.POINTER(ctypes.c_double)
    clp = ctypes.POINTER(ctypes.c_long)
    lib.kitti_evaluate(gt_data.ctypes.data_as(cdp),
                       gt_counts.ctypes.data_as(clp),
                       det_data.ctypes.data_as(cdp),
                       det_counts.ctypes.data_as(clp),
                       ctypes.c_long(n), results.ctypes.data_as(cdp),
                       curves.ctypes.data_as(cdp))
    out = {}
    idx = 0
    for ci, cls in enumerate(CLASS_NAMES):
        for di, dif in enumerate(DIFFICULTY):
            ap2d, aos, apbev, ap3d = results[idx:idx + 4]
            idx += 4
            out[f"{cls}_{dif}"] = {"AP2D": ap2d, "AOS": aos,
                                   "AP_BEV": apbev, "AP_3D": ap3d}
            if return_curves:
                out[f"{cls}_{dif}"]["curves"] = {
                    "p2d": curves[ci, di, 0].copy(),
                    "aos": curves[ci, di, 1].copy(),
                    "p_bev": curves[ci, di, 2].copy(),
                    "p_3d": curves[ci, di, 3].copy()}
    return out


def kitti_eval(results_dir, gt_dir, quiet=False):
    """Score a directory of result txts against the ground-truth label
    txts of the same names, printing the AP table (class x difficulty)."""
    ids = sorted(f[:-4] for f in os.listdir(results_dir)
                 if f.endswith(".txt"))
    gts, dets = [], []
    for i in ids:
        gts.append(parse_label_file(os.path.join(gt_dir, i + ".txt"), True))
        dets.append(parse_label_file(
            os.path.join(results_dir, i + ".txt"), False))
    out = evaluate_records(gts, dets)
    if not quiet:
        for k, v in out.items():
            print("{}: AP2D {:.2f} AOS {:.2f} BEV {:.2f} 3D {:.2f}".format(
                k, v["AP2D"], v["AOS"], v["AP_BEV"], v["AP_3D"]))
    return out


if __name__ == "__main__":
    kitti_eval(sys.argv[1], sys.argv[2])
