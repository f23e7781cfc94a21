"""The port's host C++ libraries (`csrc/*.cpp` with a plain C interface):
built with the host C++ compiler on first use into
`codenet_torch/_build/lib<stem>_<source hash>.so` and loaded with ctypes
by their modules (eval/kitti_eval.py, ops/nms.py). A failed build raises:
there is nothing to fall back to."""

from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
from pathlib import Path

BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
CXX_FLAGS = ["-O3", "-std=c++17", "-shared", "-fPIC"]


def cxx():
    for name in ("g++", "c++"):
        found = shutil.which(name)
        if found:
            return found
    raise RuntimeError("no host C++ compiler (g++ or c++) found: the port's "
                       "host libraries are built from csrc/*.cpp on first "
                       "use")


def library_path(source, stem, build_dir=BUILD_DIR):
    """Where the library built from `source` with CXX_FLAGS lives."""
    digest = hashlib.sha256(Path(source).read_bytes()
                            + " ".join(CXX_FLAGS).encode()).hexdigest()[:16]
    return Path(build_dir) / "lib{}_{}.so".format(stem, digest)


def build_shared(source, stem, build_dir=BUILD_DIR):
    """Compile `source` into `build_dir` once per source hash; returns the
    library's path. A private temporary name and an atomic rename keep a
    concurrent first use from loading a partial file."""
    Path(build_dir).mkdir(parents=True, exist_ok=True)
    out = library_path(source, stem, build_dir)
    if out.exists():
        return out
    tmp = out.with_name("{}.{}.tmp".format(out.name, os.getpid()))
    proc = subprocess.run([cxx()] + CXX_FLAGS + [str(source), "-o",
                                                 str(tmp)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError("building {} failed ({}):\n{}{}".format(
            Path(source).name, proc.returncode, proc.stdout, proc.stderr))
    tmp.replace(out)
    return out
