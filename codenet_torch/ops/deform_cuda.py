"""Co-designed depthwise deform conv: the CUDA forward kernel and its plain
PyTorch version.

`codesign_deform_conv_fast(x, s, weight)` is the port of the JAX
package's ops/deform_pallas.py::codesign_deform_conv_fast, with its op
contract: x (N, H, W, C) f32 or bf16, s (N, H, W, 1) f32, weight HWIO
(3, 3, 1, C); stride 1, padding 1, depthwise; s clamped to [-7, 8]; tap t
samples `p + a_t * s` (the Pallas form of the coordinates); each bilinear
corner zeroed separately outside the map; f32 accumulation; output in x's
dtype; any H, W and C.

Routing: a CPU tensor takes `codesign_deform_conv_plain`; a CUDA tensor
launches the kernel in `csrc/deform_fwd.cu` or raises. The kernel is the
forward only: with autograd recording and an input that requires grad,
the CUDA route raises until the backward kernel lands.

The kernel is compiled with nvcc on first use into `codenet_torch/_build/`
and loaded with ctypes. `LAUNCHES` counts kernel launches.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

import torch

from .deform_conv import ANCHOR_OFFSETS

S_LO, S_HI = -7.0, 8.0
TAPS = tuple((int(dy), int(dx)) for dy, dx in ANCHOR_OFFSETS)

_PKG = Path(__file__).resolve().parent.parent
SOURCE = _PKG / "csrc" / "deform_fwd.cu"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

LAUNCHES = 0
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_lib = None
_lib_lock = threading.Lock()


def _nvcc():
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA deform kernel is built "
                       "from csrc/deform_fwd.cu on first use")


def build():
    """Compile csrc/deform_fwd.cu into BUILD_DIR (once per source hash).

    Returns {"path", "seconds", "log", "cached"}; "log" holds nvcc's
    -Xptxas -v report (registers, shared memory, spills)."""
    digest = hashlib.sha256(SOURCE.read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    lib_path = BUILD_DIR / "libdeform_fwd_{}.so".format(digest)
    if lib_path.exists():
        return {"path": str(lib_path), "seconds": 0.0, "log": "",
                "cached": True}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # a private temporary name, then an atomic rename: concurrent first
    # uses (several processes on one checkout) never load a partial file
    tmp = lib_path.with_name("{}.{}.tmp".format(lib_path.name, os.getpid()))
    t0 = time.perf_counter()
    proc = subprocess.run([_nvcc()] + NVCC_FLAGS + ["-o", str(tmp),
                                                    str(SOURCE)],
                          capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        raise RuntimeError("nvcc failed ({}):\n{}{}".format(
            proc.returncode, proc.stdout, proc.stderr))
    tmp.replace(lib_path)
    return {"path": str(lib_path), "seconds": seconds,
            "log": proc.stdout + proc.stderr, "cached": False}


def _load():
    global _lib
    with _lib_lock:
        if _lib is None:
            lib = ctypes.CDLL(build()["path"])
            fn = lib.codesign_deform_fwd
            fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 \
                + [ctypes.c_void_p]
            fn.restype = ctypes.c_int
            _lib = lib
    return _lib


def codesign_deform_conv_plain(x, s, weight):
    """The op in plain PyTorch, on any device: same `p + a_t * s`
    coordinates, same clamp and corner zeroing as the kernel, f32
    accumulation, output in x's dtype."""
    n, h, w, c = x.shape
    hw = h * w
    xf = x.float().reshape(n, hw, c)
    sf = s.float().reshape(n, hw).clamp(S_LO, S_HI)
    wf = weight.float().reshape(9, c)
    p = torch.arange(hw, device=x.device)
    py = (p // w).float()
    px = (p % w).float()
    out = torch.zeros(n, hw, c, dtype=torch.float32, device=x.device)
    for t, (ai, aj) in enumerate(TAPS):
        sy = py + ai * sf  # (N, HW)
        sx = px + aj * sf
        y0 = torch.floor(sy)
        x0 = torch.floor(sx)
        fy = sy - y0
        fx = sx - x0
        y0 = y0.long()
        x0 = x0.long()
        tap = torch.zeros_like(out)
        for dy, dx, wgt in ((0, 0, (1 - fy) * (1 - fx)),
                            (0, 1, (1 - fy) * fx),
                            (1, 0, fy * (1 - fx)),
                            (1, 1, fy * fx)):
            yy = y0 + dy
            xx = x0 + dx
            valid = (yy >= 0) & (yy < h) & (xx >= 0) & (xx < w)
            idx = yy.clamp(0, h - 1) * w + xx.clamp(0, w - 1)
            g = torch.gather(xf, 1, idx.unsqueeze(-1).expand(-1, -1, c))
            tap = tap + g * (wgt * valid)[..., None]
        out = out + tap * wf[t]
    return out.reshape(n, h, w, c).to(x.dtype)


def _check(x, s, weight):
    if x.dim() != 4:
        raise ValueError("x must be (N, H, W, C), got {}".format(
            tuple(x.shape)))
    n, h, w, c = x.shape
    if tuple(s.shape) != (n, h, w, 1):
        raise ValueError("s must be {}, got {}".format((n, h, w, 1),
                                                       tuple(s.shape)))
    if tuple(weight.shape) != (3, 3, 1, c):
        raise ValueError("weight must be HWIO {}, got {}".format(
            (3, 3, 1, c), tuple(weight.shape)))
    if s.device != x.device or weight.device != x.device:
        raise ValueError("x, s and weight must share one device")
    if x.dtype not in _DTYPES:
        raise TypeError("x must be float32 or bfloat16, got {}".format(
            x.dtype))
    if s.dtype != torch.float32:
        raise TypeError("s must be float32, got {}".format(s.dtype))
    if not x.is_contiguous() or not s.is_contiguous():
        raise ValueError("x and s must be C-contiguous (N, H, W, C)")
    if torch.is_grad_enabled() and (x.requires_grad or s.requires_grad
                                    or weight.requires_grad):
        raise NotImplementedError(
            "the CUDA deform op is forward-only: its backward kernel "
            "(deform_pallas.py::_bwd_kernel) comes with the training "
            "slice (ROADMAP.md); run under torch.no_grad()")


def _launch(x, s, weight):
    global LAUNCHES
    n, h, w, c = x.shape
    out = torch.empty_like(x)
    w_kc = weight.reshape(9, c).to(torch.float32).contiguous()
    fn = _load().codesign_deform_fwd
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(x.data_ptr(), s.data_ptr(), w_kc.data_ptr(), out.data_ptr(),
                 n, h, w, c, _DTYPES[x.dtype], stream)
    if err != 0:
        raise RuntimeError("codesign_deform_fwd launch failed: CUDA "
                           "error {}".format(err))
    LAUNCHES += 1
    return out


def codesign_deform_conv_fast(x, s, weight):
    """Depthwise co-designed deform conv, stride 1, padding 1.

    x: (N, H, W, C) f32 or bf16; s: (N, H, W, 1) f32; weight: HWIO
    (3, 3, 1, C). CPU tensors take the plain version; CUDA tensors launch
    the kernel or raise."""
    if x.device.type == "cpu":
        return codesign_deform_conv_plain(x, s, weight)
    if x.device.type != "cuda":
        raise ValueError("unsupported device {}".format(x.device))
    _check(x, s, weight)
    return _launch(x, s, weight)
