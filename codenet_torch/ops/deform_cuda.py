"""Co-designed depthwise deform conv: the CUDA forward and backward kernels
and their plain PyTorch versions.

`codesign_deform_conv_fast(x, s, weight)` is the port of the JAX
package's ops/deform_pallas.py::codesign_deform_conv_fast, with its op
contract: x (N, H, W, C) f32 or bf16, s (N, H, W, 1) f32, weight HWIO
(3, 3, 1, C); stride 1, padding 1, depthwise; s clamped to [-7, 8]; tap t
samples `p + a_t * s` (the Pallas form of the coordinates); each bilinear
corner zeroed separately outside the map; f32 accumulation; output in x's
dtype; any H, W and C. Its gradient (the Pallas `_bwd`): dx in x's dtype,
dw in the weight's, ds zero wherever s lies outside (-7, 8) (strict: the
clamp's own tie gradient at exactly -7 and 8 does not pass).

It is a `torch.autograd.Function`. Routing is by device only: CPU tensors
take `codesign_deform_conv_plain` forward and
`codesign_deform_conv_bwd_plain` backward; CUDA tensors launch the kernels
in `csrc/deform_fwd.cu` and `csrc/deform_bwd.cu`, or raise.

The port's CUDA sources (every `csrc/*.cu`) are compiled with nvcc on
first use into `codenet_torch/_build/`, all at once (`build`), and loaded
with ctypes. `LAUNCHES` counts forward kernel launches, `BWD_LAUNCHES`
backward ones; every op module registers such counters
(`counts_launches`), and a step captured in a CUDA graph (`CountedGraph`)
adds the launches it holds to each on every replay.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

import torch

from ..utils.profile import counted_op
from .deform_conv import ANCHOR_OFFSETS, deform_conv_flops

S_LO, S_HI = -7.0, 8.0
TAPS = tuple((int(dy), int(dx)) for dy, dx in ANCHOR_OFFSETS)
CORNERS = ((0, 0), (0, 1), (1, 0), (1, 1))

_PKG = Path(__file__).resolve().parent.parent
# every CUDA source of the port, by file stem, built together
SOURCES = {p.stem: p for p in sorted((_PKG / "csrc").glob("*.cu"))}
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

# the H100 (sm_90): SMs; shared memory of an SM, the most one block may
# take, and what the SM reserves for each block
NUM_SMS = 132
SMEM_PER_SM = 233_472
SMEM_PER_BLOCK = 232_448
SMEM_RESERVED = 1024
# backward launch plan (bwd_plan); BWD_GROUP and BWD_MAX_THREADS are
# deform_bwd.cu's kGroup and kMaxThreads (its 64 registers a thread fill
# the SM's register file at 1024 threads: one block of 1024 or two of 512)
BWD_GROUP = 64
BWD_MAX_THREADS = 1024
BWD_MAX_CB = 256
BWD_GRID_MIN_CB = 8
# forward launch plan (fwd_plan); FWD_GROUP, FWD_MAX_THREADS and FWD_REACH
# are deform_fwd.cu's kGroup, kMaxThreads and kReach (a tap reaches
# |a * s| <= 8 rows, its lower corner one more)
FWD_GROUP = 128
FWD_MAX_THREADS = 512
FWD_REACH = 8
FWD_MAX_CB = 256
FWD_MIN_SLICE_BYTES = 32
FWD_WIDE_SLICE_BYTES = 128
FWD_VEC_BYTES = 16
# a band is halved to fill the card only while its tile holds at most this
# many input rows per output row; past it the slice narrows first
FWD_MAX_RESTAGE = 8

LAUNCHES = 0
BWD_LAUNCHES = 0
# the launch counters CountedGraph keeps true: (a module's globals(),
# counter name), registered by their modules (counts_launches)
_COUNTERS = []
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_ESIZE = {torch.float32: 4, torch.bfloat16: 2}
_libs = None
_lib_lock = threading.Lock()


def _nvcc():
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the port's CUDA kernels are built "
                       "from csrc/*.cu on first use")


def build():
    """Compile every source in SOURCES into BUILD_DIR (once per source
    hash), one nvcc process per source, all started together.

    Returns {name: {"path", "seconds", "log", "cached"}}; "log" holds
    nvcc's -Xptxas -v report (registers, shared memory, spills)."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out, running = {}, {}
    for name, source in SOURCES.items():
        digest = hashlib.sha256(source.read_bytes()
                                + " ".join(NVCC_FLAGS).encode()
                                ).hexdigest()[:16]
        lib_path = BUILD_DIR / "lib{}_{}.so".format(source.stem, digest)
        if lib_path.exists():
            out[name] = {"path": str(lib_path), "seconds": 0.0, "log": "",
                         "cached": True}
            continue
        # a private temporary name, then an atomic rename: concurrent first
        # uses (several processes on one checkout) never load a partial file
        tmp = lib_path.with_name("{}.{}.tmp".format(lib_path.name,
                                                    os.getpid()))
        proc = subprocess.Popen(
            [_nvcc()] + NVCC_FLAGS + ["-o", str(tmp), str(source)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        running[name] = (proc, tmp, lib_path, time.perf_counter())
    failed = []
    for name, (proc, tmp, lib_path, t0) in running.items():
        stdout, stderr = proc.communicate()
        seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            failed.append("nvcc {} failed ({}):\n{}{}".format(
                SOURCES[name].name, proc.returncode, stdout, stderr))
            continue
        tmp.replace(lib_path)
        out[name] = {"path": str(lib_path), "seconds": seconds,
                     "log": stdout + stderr, "cached": False}
    if failed:
        raise RuntimeError("\n".join(failed))
    return out


def counts_launches(namespace, *names):
    """Register module-level launch counters (`names` in `namespace`, the
    module's globals()) for CountedGraph to keep true."""
    _COUNTERS.extend((namespace, name) for name in names)


counts_launches(globals(), "LAUNCHES", "BWD_LAUNCHES")


def _load():
    global _libs
    with _lib_lock:
        if _libs is None:
            paths = build()
            fwd = ctypes.CDLL(paths["deform_fwd"]["path"])
            fwd.codesign_deform_fwd.argtypes = \
                [ctypes.c_void_p] * 4 + [ctypes.c_int] * 12 \
                + [ctypes.c_void_p]
            fwd.codesign_deform_fwd.restype = ctypes.c_int
            bwd = ctypes.CDLL(paths["deform_bwd"]["path"])
            bwd.codesign_deform_bwd.argtypes = \
                [ctypes.c_void_p] * 7 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
            bwd.codesign_deform_bwd.restype = ctypes.c_int
            _libs = {"fwd": fwd, "bwd": bwd}
    return _libs


def _compute_dtype(x):
    """The plain versions accumulate in f32, or in f64 for f64 inputs (a
    reference for parity tests; the kernels take f32 and bf16 only)."""
    return torch.float64 if x.dtype == torch.float64 else torch.float32


def _geometry(s, h, w, dtype):
    """Per tap: the clamped s's sampling coordinates split into floor and
    fraction, (N, HW) each, for the plain versions."""
    p = torch.arange(h * w, device=s.device)
    py = (p // w).to(dtype)
    px = (p % w).to(dtype)
    sf = s.to(dtype).reshape(s.shape[0], h * w).clamp(S_LO, S_HI)
    for ai, aj in TAPS:
        sy = py + ai * sf  # (N, HW)
        sx = px + aj * sf
        y0 = torch.floor(sy)
        x0 = torch.floor(sx)
        yield ai, aj, y0.long(), x0.long(), sy - y0, sx - x0


def _corner(y0, x0, dy, dx, h, w):
    """Flat index (clamped into the map) and validity of one corner."""
    yy = y0 + dy
    xx = x0 + dx
    valid = (yy >= 0) & (yy < h) & (xx >= 0) & (xx < w)
    return yy.clamp(0, h - 1) * w + xx.clamp(0, w - 1), valid


def codesign_deform_conv_plain(x, s, weight):
    """The op in plain PyTorch, on any device: same `p + a_t * s`
    coordinates, same clamp and corner zeroing as the kernel, f32
    accumulation, output in x's dtype."""
    n, h, w, c = x.shape
    cdt = _compute_dtype(x)
    xf = x.to(cdt).reshape(n, h * w, c)
    wf = weight.to(cdt).reshape(9, c)
    out = torch.zeros(n, h * w, c, dtype=cdt, device=x.device)
    for t, (_, _, y0, x0, fy, fx) in enumerate(_geometry(s, h, w, cdt)):
        tap = torch.zeros_like(out)
        for dy, dx in CORNERS:
            idx, valid = _corner(y0, x0, dy, dx, h, w)
            wgt = (fy if dy else 1 - fy) * (fx if dx else 1 - fx)
            g = torch.gather(xf, 1, idx.unsqueeze(-1).expand(-1, -1, c))
            tap = tap + g * (wgt * valid)[..., None]
        out = out + tap * wf[t]
    return out.reshape(n, h, w, c).to(x.dtype)


def codesign_deform_conv_bwd_plain(x, s, weight, g):
    """The op's gradient in plain PyTorch, on any device: (dx, ds, dw) for
    the output cotangent g, written out tap by tap and corner by corner as
    the kernel computes it (col2im as a scatter-add, dw reduced over the
    batch, ds reduced over channels with the one-sided d/ds of each corner
    weight, ds zero outside (-7, 8)). f32 throughout (f64 for f64 inputs);
    dx in x's dtype, ds in s's, dw in the weight's."""
    n, h, w, c = x.shape
    cdt = _compute_dtype(x)
    xf = x.to(cdt).reshape(n, h * w, c)
    gf = g.to(cdt).reshape(n, h * w, c)
    wf = weight.to(cdt).reshape(9, c)
    dx = torch.zeros(n, h * w, c, dtype=cdt, device=x.device)
    ds = torch.zeros(n, h * w, dtype=cdt, device=x.device)
    dw = torch.zeros(9, c, dtype=cdt, device=x.device)
    for t, (ai, aj, y0, x0, fy, fx) in enumerate(_geometry(s, h, w, cdt)):
        gw = gf * wf[t]
        sample = torch.zeros_like(xf)
        dsample = torch.zeros_like(xf)
        for dy, dx_ in CORNERS:
            idx, valid = _corner(y0, x0, dy, dx_, h, w)
            wy, dwy = (fy, ai) if dy else (1 - fy, -ai)
            wx, dwx = (fx, aj) if dx_ else (1 - fx, -aj)
            wgt = (wy * wx * valid)[..., None]
            dwgt = ((dwy * wx + wy * dwx) * valid)[..., None]
            idx = idx.unsqueeze(-1).expand(-1, -1, c)
            xv = torch.gather(xf, 1, idx)
            sample = sample + xv * wgt
            dsample = dsample + xv * dwgt
            dx.scatter_add_(1, idx, gw * wgt)
        dw[t] = (gf * sample).sum((0, 1))
        ds = ds + (gw * dsample).sum(-1)
    s_raw = s.to(cdt).reshape(n, h * w)
    ds = torch.where((s_raw > S_LO) & (s_raw < S_HI), ds, 0.0)
    return (dx.reshape(n, h, w, c).to(x.dtype),
            ds.reshape(n, h, w, 1).to(s.dtype),
            dw.reshape(weight.shape).to(weight.dtype))


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


def _stream(device):
    return torch.cuda.current_stream(device).cuda_stream


def _fwd_smem_bytes(h, w, rows, cb, esize):
    """Dynamic shared memory of one forward block (csrc/deform_fwd.cu
    smem_bytes): per position of a geometry group 6 records of 16 bytes (3
    row and 3 column coordinates); the input rows a band of `rows` output rows
    reaches, in x's type: (rows + 17) x w x cb, or the whole map."""
    tile_rows = min(h, rows + 2 * FWD_REACH + 1)
    return FWD_GROUP * 6 * 16 + tile_rows * w * cb * esize


def fwd_plan(n, h, w, c, dtype, align=FWD_VEC_BYTES):
    """A copy of `_fwd_plan`'s plan, which is computed once per
    argument tuple: a served forward asks for the same three plans on
    every call."""
    return dict(_fwd_plan(n, h, w, c, dtype, align))


@functools.lru_cache(maxsize=256)
def _fwd_plan(n, h, w, c, dtype, align):
    """Launch plan of the forward kernel for x of shape (n, h, w, c).

    vec, the channels of one thread's vector: 16 bytes (4 f32, 8 bf16),
    halved while it does not divide c or `align` (the largest power of two
    up to 16 that divides the addresses of x and of the output) is not a
    multiple of its bytes. cb, the channels of a block's slice, is a power
    of two of at least 32 bytes and vec, preferably 128 bytes (a
    quarter-warp's eight 16-byte gathers then read one position: no bank
    conflicts); rows, the output rows of a band.

    The tallest band whose tile fits two blocks to an SM at a 128-byte
    slice, else one block at the widest slice from 128 bytes down to the
    narrowest at which a band fits; then the widest slice (up to 256
    channels and c rounded up to a power of two) that still fits that
    budget at that band. Then, while the grid (one block per image, band
    and slice) has fewer blocks than the card has SMs, one more split that
    keeps it within them: the slice halved down to 128 bytes; then the
    band halved while its tile stays within FWD_MAX_RESTAGE input rows
    per output row, else the slice down to its narrowest (the other of
    the two where the first would overfill the card).
    A last slice past c and a last band past h are masked. Returns
    `fwd_plan_for`'s dict; raises ValueError where even one row at the
    narrowest slice does not fit (w above ~380).

    (tools_torch/fwd_plan_sweep.py times every plan: a band of 1-2 rows
    restages its 17 rows of reach 9-18 times, which costs more than a
    slice under 128 bytes; a slice that fits no band at 128 bytes is
    better halved once than cut to its narrowest.)"""
    esize = _ESIZE[dtype]
    vec = FWD_VEC_BYTES // esize
    while vec > 1 and (c % vec or align % (vec * esize)):
        vec //= 2
    min_cb = max(vec, FWD_MIN_SLICE_BYTES // esize)
    top_cb = max(min_cb, min(FWD_MAX_CB, 1 << (c - 1).bit_length()))
    wide_cb = max(min_cb, min(top_cb, FWD_WIDE_SLICE_BYTES // esize))

    def smem(r, k):
        return _fwd_smem_bytes(h, w, r, k, esize)

    def tallest(k, budget):
        r = h
        while r > 1 and smem(r, k) > budget:
            r -= 1
        return r if smem(r, k) <= budget else None

    pair = SMEM_PER_SM // 2 - SMEM_RESERVED
    tries = [(pair, wide_cb)]
    cb = wide_cb
    while cb >= min_cb:
        tries.append((SMEM_PER_BLOCK, cb))
        cb //= 2
    for budget, cb in tries:
        rows = tallest(cb, budget)
        if rows is not None:
            break
    else:
        raise ValueError("deform forward: a {}-wide map does not fit one "
                         "block's shared memory".format(w))
    while 2 * cb <= top_cb and smem(rows, 2 * cb) <= budget:
        cb *= 2

    def blocks(r, k):
        return n * -(-h // r) * -(-c // k)

    while blocks(rows, cb) < NUM_SMS:
        band, slice_ = (-(-rows // 2), cb), (rows, cb // 2)
        short = min(h, band[0] + 2 * FWD_REACH + 1) \
            > FWD_MAX_RESTAGE * band[0]
        if cb > wide_cb:
            splits = [slice_]
        else:
            splits = [slice_, band] if short else [band, slice_]
        splits = [sp for sp in splits if sp != (rows, cb)
                  and sp[1] >= min_cb and blocks(*sp) <= NUM_SMS]
        if not splits:
            break
        rows, cb = splits[0]
    return fwd_plan_for(n, h, w, c, dtype, rows, cb, vec)


def fwd_plan_for(n, h, w, c, dtype, rows, cb, vec):
    """The launch plan of `fwd_plan` at given rows, cb and vec: shared
    bytes, the grid and the threads, one per vector of the slice and
    position lane (at most FWD_GROUP lanes): 512 where the tile leaves
    room for one block on an SM, else 256, two blocks to an SM."""
    smem = _fwd_smem_bytes(h, w, rows, cb, _ESIZE[dtype])
    bands, slices = -(-h // rows), -(-c // cb)
    alone = 2 * (smem + SMEM_RESERVED) > SMEM_PER_SM
    threads = FWD_MAX_THREADS if alone else FWD_MAX_THREADS // 2
    return {"rows": rows, "cb": cb, "vec": vec,
            "threads": min(threads, FWD_GROUP * (cb // vec)),
            "smem_bytes": smem, "bands": bands, "slices": slices,
            "blocks": n * bands * slices}


def _alignment(*tensors):
    """The largest power of two up to FWD_VEC_BYTES that divides every
    tensor's address."""
    align = FWD_VEC_BYTES
    for t in tensors:
        while t.data_ptr() % align:
            align //= 2
    return align


def _fwd_args(x, s, weight, out, plan):
    """The forward kernel's arguments for `plan`, stream aside, and the
    (9, C) f32 tap weights they point to, which the caller holds until the
    launch. The weight goes in as the view it is, through its (tap,
    channel) strides: the model's permuted OIHW weight is not copied; a
    weight that is not f32 is cast."""
    n, h, w, c = x.shape
    w_kc = weight.reshape(9, c).to(torch.float32)
    args = (x.data_ptr(), s.data_ptr(), w_kc.data_ptr(), out.data_ptr(),
            n, h, w, c, _DTYPES[x.dtype], w_kc.stride(0), w_kc.stride(1),
            plan["rows"], plan["cb"], plan["vec"], plan["threads"],
            plan["smem_bytes"])
    return args, w_kc


def _launch(x, s, weight):
    global LAUNCHES
    n, h, w, c = x.shape
    out = torch.empty_like(x)
    plan = fwd_plan(n, h, w, c, x.dtype, align=_alignment(x, out))
    args, w_kc = _fwd_args(x, s, weight, out, plan)
    fn = _load()["fwd"].codesign_deform_fwd
    with torch.cuda.device(x.device):
        err = fn(*args, _stream(x.device))
    if err != 0:
        raise RuntimeError("codesign_deform_fwd launch failed: CUDA "
                           "error {}".format(err))
    LAUNCHES += 1
    return out


def _bwd_smem_bytes(hw, cb):
    """Dynamic shared memory of one backward block (csrc/deform_bwd.cu
    smem_bytes): the f32 dx tile (hw, cb); per position of a geometry group
    the index, weight and d(weight)/ds of 9 x 4 corners and a ds partial;
    the slice's dw partials (9, cb)."""
    return 4 * (hw * cb + BWD_GROUP * (3 * 9 * 4 + 1) + 9 * cb)


def bwd_plan(n, h, w, c):
    """Launch plan of the backward kernel for x of shape (n, h, w, c).

    cb, the channels of a block's slice, is a power of two: the largest up
    to 256 (and up to c rounded up to a power of two) whose dx tile and
    geometry fit SMEM_PER_BLOCK; then halved, but not below 8, while the
    grid (one block per image and slice) has fewer blocks than the card
    has SMs and the halved one no more (tools_torch/bwd_plan_sweep.py: a
    grid short of the SMs leaves them idle, one past them runs a second
    wave). A last slice past c is masked. Returns {"cb", "threads",
    "smem_bytes", "slices", "blocks"}; raises ValueError where even cb = 1
    does not fit (h * w above ~51,000 positions)."""
    hw = h * w
    cb = min(BWD_MAX_CB, 1 << (c - 1).bit_length())
    while cb > 1 and _bwd_smem_bytes(hw, cb) > SMEM_PER_BLOCK:
        cb //= 2
    if _bwd_smem_bytes(hw, cb) > SMEM_PER_BLOCK:
        raise ValueError("deform backward: a {}x{} map does not fit one "
                         "block's shared memory".format(h, w))
    while (cb > BWD_GRID_MIN_CB and n * -(-c // cb) < NUM_SMS
           and n * -(-c // (cb // 2)) <= NUM_SMS):
        cb //= 2
    return bwd_plan_for(n, hw, c, cb)


def bwd_plan_for(n, hw, c, cb):
    """The launch plan of `bwd_plan` at a given cb: shared bytes, the grid
    (one block per image and slice) and the threads, one per channel of
    the slice and position lane (at most BWD_GROUP lanes): 1024 where an
    SM holds one block only (its shared memory, or a grid of no more
    blocks than SMs), else 512, two blocks to an SM."""
    slices = -(-c // cb)
    smem = _bwd_smem_bytes(hw, cb)
    alone = (n * slices <= NUM_SMS
             or 2 * (smem + SMEM_RESERVED) > SMEM_PER_SM)
    threads = BWD_MAX_THREADS if alone else BWD_MAX_THREADS // 2
    return {"cb": cb, "threads": min(threads, BWD_GROUP * cb),
            "smem_bytes": smem, "slices": slices, "blocks": n * slices}


def _launch_bwd(x, s, weight, g):
    """(dx, ds, dw) from the backward kernel; g any layout of x's shape."""
    global BWD_LAUNCHES
    n, h, w, c = x.shape
    if tuple(g.shape) != tuple(x.shape) or g.device != x.device:
        raise ValueError("g must be {} on {}".format(tuple(x.shape),
                                                     x.device))
    plan = bwd_plan(n, h, w, c)
    g = g.to(x.dtype).contiguous()
    w_kc = weight.reshape(9, c).to(torch.float32).contiguous()
    dx = torch.empty_like(x)
    ds = torch.zeros(n, h, w, 1, dtype=torch.float32, device=x.device)
    dw = torch.zeros(9, c, dtype=torch.float32, device=x.device)
    fn = _load()["bwd"].codesign_deform_bwd
    with torch.cuda.device(x.device):
        err = fn(x.data_ptr(), s.data_ptr(), g.data_ptr(), w_kc.data_ptr(),
                 dx.data_ptr(), ds.data_ptr(), dw.data_ptr(),
                 n, h, w, c, _DTYPES[x.dtype], plan["cb"], plan["threads"],
                 plan["smem_bytes"], _stream(x.device))
    if err != 0:
        raise RuntimeError("codesign_deform_bwd launch failed: CUDA "
                           "error {}".format(err))
    BWD_LAUNCHES += 1
    return dx, ds, dw.reshape(weight.shape).to(weight.dtype)


class CountedGraph:
    """A torch.cuda.CUDAGraph that keeps the launch counters true: its
    capture launches nothing, so the kernel launches recorded while it
    captures are taken back off every registered counter
    (counts_launches) and kept (`captured`, by counter name), and every
    `replay` adds them again. The counters then equal the kernel events a
    profiler trace records."""

    def __init__(self):
        self.graph = torch.cuda.CUDAGraph()
        self.captured = {name: 0 for _, name in _COUNTERS}
        self.replays = 0

    @property
    def launches(self):
        """(forward, backward) deform kernel launches the graph holds."""
        return self.captured["LAUNCHES"], self.captured["BWD_LAUNCHES"]

    @contextlib.contextmanager
    def capture(self, **kwargs):
        """`torch.cuda.graph(self.graph, **kwargs)`, counting the
        launches captured."""
        before = [ns[name] for ns, name in _COUNTERS]
        with torch.cuda.graph(self.graph, **kwargs):
            yield
        for (ns, name), n in zip(_COUNTERS, before):
            self.captured[name] = ns[name] - n
            ns[name] = n

    def replay(self):
        self.graph.replay()
        self.replays += 1
        for ns, name in _COUNTERS:
            ns[name] += self.captured.get(name, 0)


def _route(x):
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError("unsupported device {}".format(x.device))
    return x.device.type == "cpu"


def _flops(x, weight):
    """The forward's FLOPs as `utils.profile.count_flops` counts them."""
    return deform_conv_flops(x.shape, weight.shape)


def codesign_deform_conv_bwd(x, s, weight, g):
    """(dx, ds, dw) of `codesign_deform_conv_fast` for cotangent g: the
    plain backward on the CPU, the backward kernel on a card. It counts
    twice the forward's FLOPs (dx and dw), as a conv's backward counts."""
    with counted_op(2 * _flops(x, weight)):
        if _route(x):
            return codesign_deform_conv_bwd_plain(x, s, weight, g)
        _check(x, s, weight)
        return _launch_bwd(x, s, weight, g)


class _CodesignDeformConv(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, s, weight):
        ctx.save_for_backward(x, s, weight)
        if _route(x):
            return codesign_deform_conv_plain(x, s, weight)
        _check(x, s, weight)
        return _launch(x, s, weight)

    @staticmethod
    def backward(ctx, g):
        return codesign_deform_conv_bwd(*ctx.saved_tensors, g)


def codesign_deform_conv_fast(x, s, weight):
    """Depthwise co-designed deform conv, stride 1, padding 1, with its
    gradient.

    x: (N, H, W, C) f32 or bf16; s: (N, H, W, 1) f32; weight: HWIO
    (3, 3, 1, C). CPU tensors take the plain versions; CUDA tensors launch
    the kernels or raise."""
    with counted_op(_flops(x, weight)):
        return _CodesignDeformConv.apply(x, s, weight)
