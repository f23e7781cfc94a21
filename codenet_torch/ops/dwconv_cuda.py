"""Depthwise 3x3 convolution whose backward is one CUDA kernel: dx and dW
(and db) from a single pass over x and dy.

`conv2d(x, weight, bias, stride, padding, dilation, groups)` is
``F.conv2d`` for every call, and routes the ones `dw_route` sends to
"kernel" through `depthwise_conv3x3`, a ``torch.autograd.Function`` whose
forward is that same ``F.conv2d`` (bit for bit) and whose backward is
`dwconv_bwd`: csrc/dwconv_bwd.cu on a card, `dwconv_bwd_plain` (torch.nn.
grad's conv2d_input and conv2d_weight, and dy summed for db) on the CPU.

`dw_route` is a pure function of what a call shows: a depthwise 3x3
conv (groups = C_in = C_out) with grad on a card goes to the kernel where
stride is 1 or 2, padding and dilation 1, x f32 and channels_last-
contiguous; every other such call to the library (cuDNN's backward).
`DW_ROUTES` counts which way each of those calls went; calls that are no
depthwise 3x3 conv with grad on a card are not counted (the CPU, serving
under inference mode, dense convs).

The kernel is compiled by nvcc with the port's other CUDA sources
(ops/deform_cuda.py::build, every csrc/*.cu at once) and loaded with
ctypes. `DW_BWD_LAUNCHES` counts its main kernel's launches (its dW
reduction is a second, small kernel of the same call); it is registered
with deform_cuda.counts_launches, so a CountedGraph adds a captured
step's launches on every replay.
`DY_COPIES` counts the dy that autograd handed over in another layout and
the wrapper made channels_last-contiguous first (a copy kernel each,
kept over replays the same way).
"""

from __future__ import annotations

import ctypes
import functools
import threading

import torch
import torch.nn.functional as F

from ..utils.profile import counted_op
from . import deform_cuda as DC

# a block's threads (csrc/dwconv_bwd.cu takes up to its kMaxThreads);
# its kMaxSlice (a slice's vectors at most: a power of two up to a warp)
# and kSums (9 tap sums and the bias's)
THREADS = 256
MAX_SLICE_VECS = 32
SUMS = 10
VEC_BYTES = 16
# a position's slice reads whole 32-byte sectors of device memory: one at
# least where each position's channels start on a sector, else two (at
# 122 channels a position is 488 bytes, and a 32-byte slice straddles two
# sectors: 64-byte slices timed 1.3-1.7x faster there, PERF.md)
SECTOR_BYTES = 32
# two blocks to an SM (the kernel's __launch_bounds__)
SMEM_BUDGET = DC.SMEM_PER_SM // 2 - DC.SMEM_RESERVED

DW_BWD_LAUNCHES = 0
DW_ROUTES = {"kernel": 0, "library": 0}
DY_COPIES = 0
DC.counts_launches(globals(), "DW_BWD_LAUNCHES", "DY_COPIES")
_lib = None
_lib_lock = threading.Lock()


def _pair(v):
    return tuple(v) if isinstance(v, (tuple, list)) else (v, v)


def dw_route(x_shape, w_shape, groups, stride, padding, dilation, device,
             dtype, channels_last, grad):
    """Where a conv2d call's backward runs: None for a call that is no
    depthwise 3x3 conv (groups = C_in = C_out, a 3x3 kernel) with grad
    (`grad`: grad enabled and x or the weight requiring it) on a card
    (`device`, a device type); "kernel" where stride is 1 or 2, padding
    and dilation 1, `dtype` float32 and x channels_last-contiguous;
    "library" for the rest (the banded convs of --spatial_shard, whose
    row padding is 0, among them)."""
    c = x_shape[1]
    if not (grad and device == "cuda" and groups == c == w_shape[0]
            and tuple(w_shape[1:]) == (1, 3, 3)):
        return None
    if (_pair(stride) in ((1, 1), (2, 2)) and _pair(padding) == (1, 1)
            and _pair(dilation) == (1, 1) and dtype == torch.float32
            and channels_last):
        return "kernel"
    return "library"


def conv2d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1):
    """``F.conv2d(x, weight, bias, stride, padding, dilation, groups)``;
    where `dw_route` says "kernel", through `depthwise_conv3x3` (the same
    forward, the backward kernel). Counts the route in DW_ROUTES. (A
    dense conv, or any under no_grad or inference mode, goes straight to
    F.conv2d: dw_route would say None.)"""
    if groups > 1 and torch.is_grad_enabled():
        route = dw_route(
            tuple(x.shape), tuple(weight.shape), groups, stride, padding,
            dilation, x.device.type, x.dtype,
            x.is_contiguous(memory_format=torch.channels_last),
            x.requires_grad or weight.requires_grad)
        if route is not None:
            DW_ROUTES[route] += 1
        if route == "kernel":
            return depthwise_conv3x3(x, weight, bias, _pair(stride)[0])
    return F.conv2d(x, weight, bias, stride, padding, dilation, groups)


def _flops(x, stride):
    """A depthwise 3x3 forward's FLOPs (a multiply-add counts 2), as
    FlopCounterMode counts aten.convolution."""
    n, c, h, w = x.shape
    return 2 * 9 * n * c * ((h - 1) // stride + 1) * ((w - 1) // stride + 1)


class _DepthwiseConv3x3(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, weight, bias, stride):
        ctx.save_for_backward(x, weight)
        ctx.stride, ctx.bias = stride, bias is not None
        return F.conv2d(x, weight, bias, stride, 1, 1, x.shape[1])

    @staticmethod
    def backward(ctx, dy):
        x, weight = ctx.saved_tensors
        dx, dw, db = dwconv_bwd(x, weight, dy, ctx.stride, ctx.bias)
        return dx, dw, db, None


def depthwise_conv3x3(x, weight, bias, stride):
    """Depthwise 3x3 conv, padding 1, stride 1 or 2, with its gradient:
    x (N, C, H, W) (channels_last on a card), weight (C, 1, 3, 3), bias
    (C,) or None. The forward is F.conv2d; the backward `dwconv_bwd`."""
    return _DepthwiseConv3x3.apply(x, weight, bias, stride)


def dwconv_bwd_plain(x, weight, dy, stride, bias):
    """(dx, dW, db) of the depthwise 3x3 conv (padding 1) for cotangent
    dy, in plain PyTorch on any device: torch.nn.grad's conv2d_input and
    conv2d_weight; db (dy summed over N, H and W) where `bias`, else
    None."""
    c = x.shape[1]
    dx = torch.nn.grad.conv2d_input(x.shape, weight, dy, stride, 1, 1, c)
    dw = torch.nn.grad.conv2d_weight(x, weight.shape, dy, stride, 1, 1, c)
    return dx, dw, dy.sum((0, 2, 3)) if bias else None


def dwconv_bwd(x, weight, dy, stride, bias):
    """(dx, dW, db) of `depthwise_conv3x3`: the plain version on the CPU,
    the kernel on a card (or raise). It counts twice the forward's FLOPs
    (dx and dW), as a conv's backward counts."""
    with counted_op(2 * _flops(x, stride)):
        if x.device.type == "cpu":
            return dwconv_bwd_plain(x, weight, dy, stride, bias)
        if x.device.type != "cuda":
            raise ValueError("unsupported device {}".format(x.device))
        return _launch(x, weight, dy, stride, bias)


def dw_bwd_smem_bytes(w, cb, vec, rows, stride):
    """Dynamic shared memory of one block (csrc/dwconv_bwd.cu smem_bytes):
    the x tile, stride x (rows - 1) + 3 input rows of w + 2 columns, and
    the dy tile, rows + 1 (+ 1 at stride 1) output rows of wo + 2
    columns, cb channels a position, f32; or, where larger, the block's
    dW partials (a group of threads each, SUMS x cb)."""
    wo = (w - 1) // stride + 1
    tiles = (stride * (rows - 1) + 3) * (w + 2) \
        + (rows + 1 + (stride == 1)) * (wo + 2)
    groups = THREADS // max(cb // vec, 32)
    return 4 * cb * max(tiles, groups * SUMS)


def min_slice_bytes(c):
    """The narrowest slice of a position's c f32 channels (SECTOR_BYTES)."""
    return SECTOR_BYTES * (1 if 4 * c % SECTOR_BYTES == 0 else 2)


def dw_bwd_plan(n, h, w, c, stride, align=VEC_BYTES):
    """A copy of `_dw_bwd_plan`'s plan, computed once per argument
    tuple."""
    return dict(_dw_bwd_plan(n, h, w, c, stride, align))


@functools.lru_cache(maxsize=256)
def _dw_bwd_plan(n, h, w, c, stride, align):
    """Launch plan of the backward kernel for x of shape (n, c, h, w).

    vec, the channels of one thread's vector: 16 bytes (4 f32), halved
    while it does not divide c or `align` (the largest power of two up to
    16 dividing the addresses of x and dy) is not a multiple of its
    bytes. cb, the channels of a block's slice: a power of two of vectors
    (at most a warp's), as many as make the block's THREADS threads one
    per (output column, vector) (THREADS / wo), at least `min_slice_bytes`
    a position and at most c rounded up. rows, the output rows of a band:
    the most whose tiles fit SMEM_BUDGET (two blocks to an SM), evened
    out over the bands, then halved while the grid (one block per image,
    band and slice) has fewer blocks than the card has SMs. A last slice
    past c and a last band past the output's rows are masked. Returns
    {"vec", "cb", "rows", "threads", "smem_bytes", "bands", "slices",
    "blocks"}; raises ValueError where one output row at a one-vector
    slice does not fit (w above ~7,000 columns)."""
    vec = VEC_BYTES // 4
    while vec > 1 and (c % vec or align % (4 * vec)):
        vec //= 2
    ho, wo = (h - 1) // stride + 1, (w - 1) // stride + 1
    want = 1 << (-(-THREADS // wo) - 1).bit_length()
    most = 1 << (-(-c // vec) - 1).bit_length()
    cbv = min(MAX_SLICE_VECS, most,
              max(want, min_slice_bytes(c) // (4 * vec)))

    def smem(r, k):
        return dw_bwd_smem_bytes(w, k * vec, vec, r, stride)

    while True:
        rows = ho
        while rows > 1 and smem(rows, cbv) > SMEM_BUDGET:
            rows -= 1
        if smem(rows, cbv) <= SMEM_BUDGET:
            break
        if cbv == 1:
            raise ValueError("depthwise backward: a {}-wide map does not "
                             "fit one block's shared memory".format(w))
        cbv //= 2
    rows = -(-ho // -(-ho // rows))
    slices = -(-c // (cbv * vec))
    while rows > 1 and n * -(-ho // rows) * slices < DC.NUM_SMS:
        rows = -(-rows // 2)
    bands = -(-ho // rows)
    return {"vec": vec, "cb": cbv * vec, "rows": rows, "threads": THREADS,
            "smem_bytes": smem(rows, cbv), "bands": bands, "slices": slices,
            "blocks": n * bands * slices}


def _load():
    global _lib
    with _lib_lock:
        if _lib is None:
            lib = ctypes.CDLL(DC.build()["dwconv_bwd"]["path"])
            lib.dwconv_bwd.argtypes = [ctypes.c_void_p] * 7 \
                + [ctypes.c_int] * 10 + [ctypes.c_void_p]
            lib.dwconv_bwd.restype = ctypes.c_int
            _lib = lib
    return _lib


def _check(x, weight, dy, stride):
    n, c, h, w = x.shape
    ho, wo = (h - 1) // stride + 1, (w - 1) // stride + 1
    if tuple(weight.shape) != (c, 1, 3, 3):
        raise ValueError("weight must be {}, got {}".format(
            (c, 1, 3, 3), tuple(weight.shape)))
    if tuple(dy.shape) != (n, c, ho, wo):
        raise ValueError("dy must be {}, got {}".format(
            (n, c, ho, wo), tuple(dy.shape)))
    if stride not in (1, 2):
        raise ValueError("stride must be 1 or 2, got {}".format(stride))
    if weight.device != x.device or dy.device != x.device:
        raise ValueError("x, weight and dy must share one device")
    if x.dtype != torch.float32 or dy.dtype != torch.float32:
        raise TypeError("x and dy must be float32, got {} and {}".format(
            x.dtype, dy.dtype))
    if not x.is_contiguous(memory_format=torch.channels_last):
        raise ValueError("x must be channels_last-contiguous")


def _launch(x, weight, dy, stride, bias):
    """(dx, dW, db) from the backward kernel; dy in any layout."""
    global DW_BWD_LAUNCHES, DY_COPIES
    _check(x, weight, dy, stride)
    if not dy.is_contiguous(memory_format=torch.channels_last):
        dy = dy.contiguous(memory_format=torch.channels_last)
        DY_COPIES += 1
    n, c, h, w = x.shape
    plan = dw_bwd_plan(n, h, w, c, stride, align=DC._alignment(x, dy))
    w_c9 = weight.reshape(c, 9).to(torch.float32).contiguous()
    dx = torch.empty_like(x, memory_format=torch.channels_last)
    part = torch.empty(n * plan["bands"], SUMS, c, dtype=torch.float32,
                       device=x.device)
    dw = torch.empty(c, 9, dtype=torch.float32, device=x.device)
    db = torch.empty(c, dtype=torch.float32, device=x.device) \
        if bias else None
    fn = _load().dwconv_bwd
    with torch.cuda.device(x.device):
        err = fn(x.data_ptr(), dy.data_ptr(), w_c9.data_ptr(),
                 dx.data_ptr(), part.data_ptr(), dw.data_ptr(),
                 db.data_ptr() if bias else None, n, h, w, c, stride,
                 plan["vec"], plan["cb"], plan["rows"], plan["threads"],
                 plan["smem_bytes"], DC._stream(x.device))
    if err != 0:
        raise RuntimeError("dwconv_bwd launch failed: CUDA error "
                           "{}".format(err))
    DW_BWD_LAUNCHES += 1
    return dx, dw.view(c, 1, 3, 3).to(weight.dtype), db
