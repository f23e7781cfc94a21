"""Smoke test of the PyTorch port on one CUDA card.

    python3 chip_smoke.py [--out FILE]

Builds the co-designed deform conv kernels (codenet_torch/csrc/
deform_fwd.cu and deform_bwd.cu, one nvcc each, in parallel, beside the
host KITTI scorer csrc/kitti_eval.cpp) and holds each kernel against its
plain PyTorch version at the shapes the model gives it (the forward at
batches 2, 32, 64 and 128, and at the non-square maps of --keep_res
requests; the deform backbone's 32x32x58, 16x16x116 and 8x8x232; the
512^2 maps 16x16x1024, 32x32x256 and 64x64x128; KITTI's 12x40x1024,
24x80x256 and 48x160x128) and at ragged ones, timing both. Then it drives the port's paths at full width
(ctdet ShuffleNetV2-DCN 1x, 256^2, unless said otherwise):

- serving: flip-test per-image requests and a batch-32 request through
  CtdetDetector, scored with the port's VOC evaluator;
- FP32 training: one step card vs CPU at batch 4, then timed steps at
  batch 32 on port-sampler batches of synthetic frames;
- W4A8 QAT: one step card vs CPU at batch 4, then the trained weights
  saved and reloaded through the port's checkpoint, timed steps at batch
  32, and a fake-quant CtdetDetector eval;
- the CLIs: `cli.main` (train, checkpoint, LR drop, final eval) and
  `cli.quant_main` from its checkpoint;
- real int8: the QAT-trained model exported to the W4A8 artifact
  (engine/w4a8.py) and served with --int8_infer from its .pth and from
  the artifact (equal detections); card vs CPU and int8 vs act-clamp
  fake-quant heads; every int8 conv's accumulator held to the exact
  integers; the int8 and fake-quant forwards timed; `cli.test
  --int8_infer` on the CLI's QAT checkpoint and on its artifact
  (tools_torch/export_w4a8.py);
- the image cache (--device_cache): the train frames on the card, a
  cache batch against a host batch, the cache loader and timed steps
  beside the host ones, and `cli.main --device_cache`;
- batched eval (`cli.test --batch_eval 32`) with the host warp,
  --device_warp and --device_cache;
- multi-scale flip-test requests merged by soft-NMS, at fix_res with
  --nms and with --keep_res, card vs CPU port;
- bf16 conv operands (--dtype bfloat16): served heads card vs CPU,
  per-image and batch-32 requests in turns with f32, a --nms request and
  `cli.test --batch_eval 32 --device_warp`; a train step card vs CPU,
  timed steps in turns with f32 (the backward kernel in bf16), and QAT
  steps against f32 QAT; the CLIs (`cli.main`, `cli.quant_main`,
  `cli.test --resume-quantize` and `--int8_infer`) with --dtype
  bfloat16 in the cli phase;
- the deform backbone: a forward card vs CPU (16 forward launches), a
  train step card vs CPU in f32 and in bf16, and the int8 refusal;
- ctdet on COCO at 512^2 (80 classes): heads card vs CPU, flip-test
  requests and batch-32 requests, `cli.test` per image and batched,
  scored by the port's COCO evaluator;
- multi_pose (COCO keypoints) at 512^2: heads and multi_pose_decode card
  vs CPU, flip-test requests and a 5-scale --nms request, a train step
  card vs CPU and timed steps at batch 32, then `cli.main` ->
  `cli.quant_main` -> `cli.test --resume-quantize`, scored by the
  keypoint COCO evaluator;
- ddd (KITTI 3D) at 384x1280 on synthetic KITTI frames (2D boxes
  projected from seeded 3D boxes through each frame's P2): both kernels
  at KITTI's maps (12x40x1024, 24x80x256, 48x160x128; forward at batches
  1 and 16, backward at 16), heads and ddd_decode card vs CPU, requests
  with their own calib, a train step card vs CPU and timed steps at
  batch 16, then `cli.main` -> `cli.quant_main` -> `cli.test` (prefetched
  and serial), scored by the port's KITTI scorer (csrc/kitti_eval.cpp,
  built with the host C++ compiler);
- exdet (ExtremeNet) at 512^2 on the COCO set with extreme points: heads
  and exct_decode (K 100, its time and peak memory) card vs CPU,
  flip-test requests, a train step card vs CPU and timed steps at batch
  32, then `cli.main` -> `cli.quant_main` -> `cli.test`, scored by the
  port's COCO evaluator.

Every phase prints one JSON line; a phase that fails ends the script with
a non-zero exit. The last three lines are the card (nvidia-smi), the kernel
table ({"kernels": [...]}) and {"ok": true, "device": {...}}.

Weights are random (seeded): for serving, BN running stats are set from a
random batch and the deform scale predictors are redrawn, so that s is
fractional and partly outside the maps; training starts from the port's
init (s == 1), its card-vs-CPU parity steps (FP32 and QAT) from that init
with the BN biases raised (conditioned_init). Images are synthetic frames
held in memory (the dataset's `load_image` is overridden; the card's
machine has no cv2). TF32 is off throughout: the parity phases compare
FP32 against FP32.
"""

from __future__ import annotations

import argparse
import contextlib
import copy
import io
import json
import subprocess
import sys
import time
import types
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
SEED = 0
# (H, W, C) of the three deconv-stage deform calls at 256^2 input, 1x
MODEL_SHAPES = [(8, 8, 1024), (16, 16, 256), (32, 32, 128)]
# and of the deform backbone's stride-1 calls, with their count in one
# forward (stages of 3, 7 and 3 stride-1 nodes)
BACKBONE_SHAPES = [(32, 32, 58), (16, 16, 116), (8, 8, 232)]
BACKBONE_CALLS = {(32, 32, 58): 3, (16, 16, 116): 7, (8, 8, 232): 3}
# the COCO family (ctdet on COCO, multi_pose on COCO keypoints) at
# CenterNet's published 512^2: its three deconv-stage maps
COCO_RES = 512
COCO_SHAPES = [(16, 16, 1024), (32, 32, 256), (64, 64, 128)]
COCO_HEADS = {"hm": 80, "wh": 2, "reg": 2}
POSE_HEADS = {"hm": 1, "wh": 2, "hps": 34, "reg": 2, "hm_hp": 17,
              "hp_offset": 2}
# multi_pose_decode on the same heads, card vs CPU (output-map pixels)
DECODE_TOL = 1e-4
# ddd on KITTI at CenterNet's 384x1280 (--kitti_split 3dop): KITTI's
# camera frames (h, w), the deconv stage's three maps, and the ddd_3dop
# recipe's train batch
KITTI_HW = (384, 1280)
KITTI_FRAME = (375, 1242)
KITTI_SHAPES = [(12, 40, 1024), (24, 80, 256), (48, 160, 128)]
KITTI_TRAIN_BATCH = 16
DDD_HEADS = {"hm": 3, "dep": 1, "rot": 8, "dim": 3, "wh": 2, "reg": 2}
# exdet (ExtremeNet) at 512^2: four extreme-point heatmaps, the centre
# one (80 classes each) and the four points' offsets
EXDET_HEADS = dict({"hm_" + p: 80 for p in "tlbrc"},
                   **{"reg_" + p: 2 for p in "tlbr"})
# ddd's and exdet's heads card vs CPU, each within this of its max; and
# their parity steps' batch (the CPU step at 384x1280 and 512^2)
TASK_HEAD_TOL = 1e-5
TASK_STEP_BATCH = 2
# exct_decode's kept scores, card vs CPU on the same heads
LATTICE_SCORE_TOL = 1e-6
RAGGED_SHAPES = [(12, 12, 58), (16, 16, 2153), (24, 24, 32)]
# both kernels also at KITTI's largest deconv map (the forward's bands clip
# at both edges; the backward's slices are 4 channels wide)
BWD_SHAPES = MODEL_SHAPES + RAGGED_SHAPES + [(48, 160, 64)]
# forward: the model's shapes at the served batch (2), the train forward
# (32), a batch-32 request with its flipped copies (64) and 128; the other
# shapes at 2 and 128
BATCHES = [2, 32, 64, 128]
RAGGED_BATCHES = [2, 128]
BWD_BATCHES = [32, 128]
TRAIN_BATCH = 32
RES = 256  # the served and trained input (config a)
TOL = {torch.float32: 1e-4, torch.bfloat16: 3e-2}
# --keep_res kernel cases: VOC's two frame shapes (h, w) at these scales
KEEP_RES_FRAMES = [(375, 500), (500, 375)]
KEEP_RES_SCALES = [0.5, 1.0, 1.5]
# the multi-scale flip test (CenterNet's published protocol)
TEST_SCALES = "0.5,0.75,1,1.25,1.5"
# multi-scale requests that the CPU port also answers, for card vs CPU
CPU_REQUESTS = 4
# card vs CPU on merged multi-scale detections: at least MATCH_SHARE of
# the boxes within BOX_TOL px and SCORE_TOL of score
MATCH_SHARE, BOX_TOL, SCORE_TOL = 0.97, 1e-2, 1e-4
# --device_warp vs the host warp (tests/test_batch_eval.py's criterion):
# at least MATCH_SHARE of the boxes within 1 px and 0.05 of score
WARP_BOX_TOL, WARP_SCORE_TOL = 1.0, 0.05
# the cache path's warped pixels (f32, unrounded) vs the host path's
# uint8 ones: half a level, plus f32 rounding
CACHE_PIXEL_TOL = 0.5 + 1e-3
# card vs CPU on one train / QAT step: loss, and gradients (relative L2
# over all parameters; the median tensor and each deform-block tensor
# relative to its max)
STEP_TOL = 5e-3
# the same with bf16 conv operands (--dtype bfloat16): bf16 heads card vs
# CPU, each within this of its max; a step's loss, and its gradients
# (relative L2 over all parameters, the worst tensor reported)
BF16_HEAD_TOL = 3e-2
BF16_LOSS_TOL, BF16_GRAD_TOL = 3e-2, 5e-2
# the deform backbone's f32 heads card vs CPU
BACKBONE_HEAD_TOL = 2e-3
# bf16 QAT against f32 QAT from one start (the JAX package's
# test_qat_bf16_matches_f32_numerics): losses relative, ranges rtol/atol
QAT_BF16_LOSS_TOL, QAT_BF16_RANGE_TOL = 0.05, 5e-2
# the parity steps' start: BN biases raised by this (conditioned_init)
BN_SHIFT = 3.0
# int8 heads of the QAT-trained model: card vs CPU, and int8 (as served,
# and sampling the deform conv in f32) vs the act-clamp fake-quant, each
# head within this of its max |value|. A level that rounds the other way
# moves through every later quantizer: random weights move reg and wh by
# 4-7% (tests/test_torch_int8.py); this QAT-trained model moved them by
# under 1% on an H100.
INT8_TOL = 2e-2
DEFORM_PARAMS = tuple("deconv_layers.{}.{}.".format(4 * i, part)
                      for i in range(3)
                      for part in ("conv_scale", "conv", "conv_channel"))
# memory rate (B/s) and fp32 CUDA-core peak (FLOP/s) by card name
# (NVIDIA data sheets); the first match wins, SXM is the default
CARD_PEAKS = [("H200", 4.8e12, 67e12), ("H100 NVL", 3.9e12, 60e12),
              ("PCIe", 2.0e12, 51e12), ("H100", 3.35e12, 67e12)]
FLOPS_PER_OUT = 90  # 9 taps x (4 corner mul-adds + 1 tap-weight mul-add)
# backward, per element of x: 9 taps x (4-corner sample 8, g*w 1, 4 col2im
# products and adds 8, dw FMA 2) + 8 off-centre taps x (4-corner d/ds 8,
# ds FMA 2)
BWD_FLOPS_PER_ELEM = 9 * (8 + 1 + 8 + 2) + 8 * (8 + 2)

_lines = []


def emit(obj):
    line = obj if isinstance(obj, str) else json.dumps(obj)
    _lines.append(line)
    print(line, flush=True)


def card_peaks(name):
    for key, bw, flops in CARD_PEAKS:
        if key in name:
            return bw, flops
    return CARD_PEAKS[-1][1:]


def cuda_time_ms(fn, iters, warmup=3):
    """Wall time per call on the card's clock (CUDA events), host dispatch
    included: a call the host issues slower than the card runs it is
    timed at the host's rate."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


@contextlib.contextmanager
def cudnn_tf32(on):
    """cuDNN convs allowed TF32 within the block (PyTorch's own default)
    where `on`. The script sets it off for its f32 parity phases; the
    bf16 model's convs take bf16 operands, which TF32 holds exactly, so
    its phases allow it and run those convs on tensor cores."""
    before = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = bool(on) or before
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = before


def graph_time_ms(fn, iters):
    """Device time per call: `iters` calls captured in one CUDA graph and
    replayed, so host dispatch drops out (graph launch gaps stay in)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()  # warm-up off the capture, as CUDA graph capture requires
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    del graph
    return start.elapsed_time(end) / iters


def phase_env():
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    emit(smi)
    emit({"phase": "env", "nvidia_smi": smi, "torch": torch.__version__,
          "cuda": torch.version.cuda, "python": sys.version.split()[0],
          "device": torch.cuda.get_device_name(0),
          "cudnn_allow_tf32": torch.backends.cudnn.allow_tf32,
          "matmul_allow_tf32": torch.backends.cuda.matmul.allow_tf32})
    return smi


def phase_build():
    """Both kernels (nvcc) and the KITTI scorer (the host C++ compiler),
    all built together."""
    from concurrent.futures import ThreadPoolExecutor
    from codenet_torch.eval import kitti_eval
    from codenet_torch.ops import deform_cuda as DC

    def build_scorer():
        t0 = time.perf_counter()
        cached = kitti_eval.library_path().exists()
        return kitti_eval.build(), time.perf_counter() - t0, cached
    with ThreadPoolExecutor(1) as pool:
        scorer = pool.submit(build_scorer)
        kernels = DC.build()
        path, seconds, cached = scorer.result()
    emit({"phase": "build", "kernel": "kitti_eval (host C++)",
          "so": str(path.relative_to(ROOT)), "cxx_s": round(seconds, 3),
          "cached": cached})
    for name, info in kernels.items():
        ptxas = [ln.strip() for ln in info["log"].splitlines()
                 if "registers" in ln or "spill" in ln]
        emit({"phase": "build", "kernel": name,
              "so": str(Path(info["path"]).relative_to(ROOT)),
              "nvcc_s": round(info["seconds"], 3), "cached": info["cached"],
              "ptxas": ptxas})


def _mixed_s(n, h, w, gen):
    """s fractional in [-9, 10), a quarter of it rounded to integers and a
    quarter exactly at the clamp bounds -7 and 8."""
    s = torch.rand(n, h, w, 1, generator=gen) * 19.0 - 9.0
    pick = torch.randint(0, 4, s.shape, generator=gen)
    bounds = torch.where(torch.rand(s.shape, generator=gen) < 0.5, -7.0, 8.0)
    return torch.where(pick == 0, s.round(), torch.where(pick == 1, bounds,
                                                         s))


def _case(shape, n, dtype, gen):
    h, w, c = shape
    x = torch.randn(n, h, w, c, generator=gen).to("cuda", dtype)
    s = _mixed_s(n, h, w, gen).cuda()
    wt = (torch.randn(3, 3, 1, c, generator=gen) * 0.2).to("cuda", dtype)
    return x, s, wt


def _fwd_row(phase, shape, n, dtype, gen, bw, flops, iters=200):
    """One forward case: the kernel (one launch) against its plain version
    on the same inputs, both timed, with the bound and the launch plan
    (deform_cuda.fwd_plan); emitted, and the script ends if it fails."""
    from codenet_torch.ops import deform_cuda as DC
    x, s, wt = _case(shape, n, dtype, gen)
    before = DC.LAUNCHES
    out = DC.codesign_deform_conv_fast(x, s, wt)
    torch.cuda.synchronize()
    launched = DC.LAUNCHES - before
    ref = DC.codesign_deform_conv_plain(x, s, wt)
    err = float((out.float() - ref.float()).abs().max())
    ms = graph_time_ms(lambda: DC.codesign_deform_conv_fast(x, s, wt), iters)
    call_ms = cuda_time_ms(lambda: DC.codesign_deform_conv_fast(x, s, wt),
                           iters)
    plain_ms = graph_time_ms(lambda: DC.codesign_deform_conv_plain(x, s, wt),
                             10)
    elems = x.numel()
    nbytes = 2 * elems * x.element_size() + s.numel() * 4 + 9 * shape[2] * 4
    t_bytes = nbytes / bw * 1e3
    t_ops = elems * FLOPS_PER_OUT / flops * 1e3
    plan = DC.fwd_plan(n, *shape, dtype)
    row = {"phase": phase, "shape": list(shape), "n": n,
           "dtype": str(dtype).split(".")[-1],
           **{k: plan[k] for k in ("rows", "cb", "vec", "threads",
                                   "smem_bytes", "blocks")},
           "max_abs_err": err, "tol": TOL[dtype], "launches": launched,
           "ms": ms, "call_ms": call_ms, "plain_ms": plain_ms,
           "bound_us": max(t_bytes, t_ops) * 1e3,
           "bound_by": "bytes" if t_bytes >= t_ops else "operations",
           "model_shape": shape in MODEL_SHAPES,
           "backbone_shape": shape in BACKBONE_SHAPES,
           "coco_shape": shape in COCO_SHAPES,
           "kitti_shape": shape in KITTI_SHAPES}
    emit(row)
    if launched != 1 or not err <= TOL[dtype]:
        raise SystemExit("{} check failed: {}".format(phase, row))
    return row


def phase_kernels(bw, flops):
    """Forward kernel vs its plain version on the card at every shape,
    batch, dtype; each row with its launch plan (deform_cuda.fwd_plan).
    The deform backbone's, the 512^2 and KITTI's maps at the served and
    trained batches."""
    gen = torch.Generator().manual_seed(SEED)
    cases = [(shape, n) for shape in BWD_SHAPES
             for n in (BATCHES if shape in MODEL_SHAPES
                       else RAGGED_BATCHES)]
    cases += [(shape, n) for shape in BACKBONE_SHAPES + COCO_SHAPES
              for n in (2, TRAIN_BATCH)]
    cases += [(shape, n) for shape in KITTI_SHAPES
              for n in (1, KITTI_TRAIN_BATCH)]
    return [_fwd_row("kernel", shape, n, dtype, gen, bw, flops)
            for shape, n in cases
            for dtype in (torch.float32, torch.bfloat16)]


def keep_res_maps(height, width, scale):
    """(H, W, C) of the three deform calls of a --keep_res request for a
    height x width frame at `scale`: input (new | 31) + 1 on each side,
    deconv maps at /32, /16 and /8 (engine/detector.py::pre_process)."""
    ih = (int(height * scale) | 31) + 1
    iw = (int(width * scale) | 31) + 1
    return [(ih // 32, iw // 32, 1024), (ih // 16, iw // 16, 256),
            (ih // 8, iw // 8, 128)]


def phase_kernel_keep_res(bw, flops):
    """The forward kernel vs its plain version at the --keep_res maps of a
    500x375 and a 375x500 frame at scales 0.5, 1 and 1.5 (flip-test batch
    2, f32): non-square, changing per image, never run by the fixed 256^2
    paths. Returns the rows and, per request (frame, scale), the three
    calls' summed ms and bound."""
    gen = torch.Generator().manual_seed(SEED + 3)
    rows = {}
    per_request = {}
    for h, w in KEEP_RES_FRAMES:
        for scale in KEEP_RES_SCALES:
            shapes = keep_res_maps(h, w, scale)
            for shape in shapes:
                if shape not in rows:
                    rows[shape] = _fwd_row("kernel_keep_res", shape, 2,
                                           torch.float32, gen, bw, flops, 50)
            per_request["{}x{}@{}".format(w, h, scale)] = {
                "ms": sum(rows[sh]["ms"] for sh in shapes),
                "bound_ms": sum(rows[sh]["bound_us"] for sh in shapes) / 1e3,
                "plain_ms": sum(rows[sh]["plain_ms"] for sh in shapes)}
    emit({"phase": "kernel_keep_res_requests", "requests": per_request})
    return list(rows.values()), per_request


def _bwd_case(shape, n, dtype, gen):
    """x, s (_mixed_s), w, g for the backward."""
    h, w, c = shape
    x = torch.randn(n, h, w, c, generator=gen)
    s = _mixed_s(n, h, w, gen)
    wt = torch.randn(3, 3, 1, c, generator=gen) * 0.2
    g = torch.randn(n, h, w, c, generator=gen)
    return (x.to("cuda", dtype), s.cuda(), wt.to("cuda", dtype),
            g.to("cuda", dtype))


def phase_kernel_bwd(bw, flops):
    """Backward kernel vs the plain backward at every shape, batch, dtype
    (the deform backbone's, the 512^2 and KITTI's maps at the trained
    batch): error
    of dx, ds and dw relative to each output's max; each row with its
    launch plan (deform_cuda.bwd_plan)."""
    from codenet_torch.ops import deform_cuda as DC
    gen = torch.Generator().manual_seed(SEED + 2)
    rows = []
    cases = [(shape, n) for shape in BWD_SHAPES for n in BWD_BATCHES]
    cases += [(shape, TRAIN_BATCH) for shape in BACKBONE_SHAPES
              + COCO_SHAPES]
    cases += [(shape, KITTI_TRAIN_BATCH) for shape in KITTI_SHAPES]
    for shape, n in cases:
        for dtype in (torch.float32, torch.bfloat16):
            x, s, wt, g = _bwd_case(shape, n, dtype, gen)
            before = DC.BWD_LAUNCHES
            got = DC.codesign_deform_conv_bwd(x, s, wt, g)
            torch.cuda.synchronize()
            launched = DC.BWD_LAUNCHES - before
            ref = DC.codesign_deform_conv_bwd_plain(x, s, wt, g)
            errs = {}
            for name, a, b in zip(("dx", "ds", "dw"), got, ref):
                scale = float(b.float().abs().max())
                errs[name] = float((a.float() - b.float()).abs().max())
                errs[name + "_rel"] = errs[name] / scale
            at_bounds = (s == -7.0) | (s == 8.0)
            ds_at_bounds = float(got[1][at_bounds].abs().max())
            ms = graph_time_ms(
                lambda: DC.codesign_deform_conv_bwd(x, s, wt, g), 50)
            plain_ms = graph_time_ms(
                lambda: DC.codesign_deform_conv_bwd_plain(x, s, wt, g),
                3)
            elems = x.numel()
            npos = s.numel()
            # what the op must move: x, g, s and w read once, dx (x's
            # type), ds and dw written once; the zeroing of ds and dw
            # that the kernel's atomics need counts in `ms` only
            nbytes = 3 * elems * x.element_size() + 2 * npos * 4 \
                + 2 * 9 * shape[2] * wt.element_size()
            t_bytes = nbytes / bw * 1e3
            t_ops = elems * BWD_FLOPS_PER_ELEM / flops * 1e3
            plan = DC.bwd_plan(n, *shape)
            row = {"phase": "kernel_bwd", "shape": list(shape), "n": n,
                   "dtype": str(dtype).split(".")[-1],
                   "cb": plan["cb"], "smem_bytes": plan["smem_bytes"],
                   "blocks": plan["blocks"], **errs,
                   "ds_at_bounds": ds_at_bounds, "tol_rel": TOL[dtype],
                   "launches": launched, "ms": ms, "plain_ms": plain_ms,
                   "bound_us": max(t_bytes, t_ops) * 1e3,
                   "bound_by": "bytes" if t_bytes >= t_ops
                   else "operations",
                   "model_shape": shape in MODEL_SHAPES,
                   "backbone_shape": shape in BACKBONE_SHAPES,
                   "coco_shape": shape in COCO_SHAPES,
                   "kitti_shape": shape in KITTI_SHAPES}
            emit(row)
            rows.append(row)
            worst = max(errs[k + "_rel"] for k in ("dx", "ds", "dw"))
            if launched != 1 or not worst <= TOL[dtype] \
                    or ds_at_bounds != 0.0:
                raise SystemExit("kernel_bwd check failed: {}".format(
                    row))
    return rows


def _hw(res):
    """(h, w) of an input size given as one side or as (h, w)."""
    return (res, res) if isinstance(res, int) else tuple(res)


@torch.no_grad()
def build_served_model(device="cuda", deform_backbone=False,
                       heads=None, res=RES):
    """Full-width PoseShuffleNetV2 1x on `device` (with deform_backbone,
    that variant; the VOC ctdet heads unless `heads`; calibrated at
    `res`^2, or at (h, w) = `res`), random but not degenerate: every deform block's
    conv_scale redrawn (s fractional, partly off the map), BN running
    stats set from a random batch, each channel's variance at least twice
    its layer's mean. Without that floor near-dead channels are
    normalised to unit variance and the random network amplifies f32
    rounding until the card's and the CPU's heads differ by ~1e-3 of
    their range; with it they agree to ~1e-6."""
    from codenet_torch.models import create_model
    from codenet_torch.models.layers import CodesignDeformBlock
    gen = torch.Generator().manual_seed(SEED)
    model = create_model("shufflenetv2",
                         heads or {"hm": 20, "wh": 2, "reg": 2}, 64,
                         deform_backbone=deform_backbone, device=device,
                         generator=gen)
    for block in model.modules():
        if not isinstance(block, CodesignDeformBlock):
            continue
        cs = block.conv_scale
        cin = cs.weight.shape[1]
        cs.weight.copy_(torch.randn(cs.weight.shape, generator=gen)
                        * 3.0 / cin ** 0.5)
        cs.bias.copy_(torch.rand(1, generator=gen) * 5.0 - 2.0)
    bns = [m for m in model.modules()
           if isinstance(m, torch.nn.BatchNorm2d)]
    for m in bns:
        m.reset_running_stats()
        m.momentum = None
    model.train()
    model(torch.randn(8, *_hw(res), 3, generator=gen).to(device))
    for m in bns:
        m.momentum = 0.1
        m.running_var.clamp_(min=2.0 * float(m.running_var.mean()))
        m.weight.mul_(torch.rand(m.weight.shape, generator=gen).to(device)
                      + 0.5)
        m.bias.add_(torch.randn(m.bias.shape, generator=gen).to(device)
                    * 0.1)
    return model.eval()


@torch.no_grad()
def heads_card_vs_cpu(model, tol, launches, res=RES):
    """A `res`^2 (or (h, w) = `res`) batch-2 forward on the card (kernels)
    vs on the CPU (plain) from the same weights: per head the shape, max |difference| and its
    ratio to the head's max |value|, finiteness; ok when every head is
    finite and within `tol` and the card's forward launched the forward
    kernel `launches` times."""
    from codenet_torch.ops import deform_cuda as DC
    gen = torch.Generator().manual_seed(SEED + 1)
    images = torch.randn(2, *_hw(res), 3, generator=gen)
    cpu_model = copy.deepcopy(model).cpu()
    before = DC.LAUNCHES
    out = model(images.cuda())
    torch.cuda.synchronize()
    launched = DC.LAUNCHES - before
    ref = cpu_model(images)
    heads = {}
    ok = launched == launches
    for name, r in ref.items():
        o = out[name].cpu()
        scale = float(r.abs().max())
        err = float((o - r).abs().max())
        heads[name] = {"shape": list(o.shape), "max_abs_err": err,
                       "max_rel_err": err / scale, "finite": bool(
                           torch.isfinite(o).all())}
        ok = ok and heads[name]["finite"] and err <= tol * scale
    return {"launches": launched, "heads": heads, "tol_rel": tol}, ok


def phase_model(model):
    """256^2 batch-2 forward on the card (kernel) vs on the CPU (plain)."""
    out, ok = heads_card_vs_cpu(model, 1e-3, 3)
    emit({"phase": "model", **out})
    if not ok:
        raise SystemExit("model check failed")


def synthetic_frames(n):
    """VOC-sized uint8 BGR frames (500x375 / 375x500) of noise with 1-3
    filled boxes each; returns the frames and COCO-format ground truth."""
    rng = np.random.RandomState(SEED)
    frames, images, anns = [], [], []
    for i in range(n):
        w, h = (500, 375) if i % 2 == 0 else (375, 500)
        img = (rng.rand(h, w, 3) * 60).astype(np.uint8)
        for _ in range(rng.randint(1, 4)):
            bw, bh = rng.randint(16, w // 2), rng.randint(16, h // 2)
            x, y = rng.randint(0, w - bw), rng.randint(0, h - bh)
            cls = int(rng.randint(0, 20))
            img[y:y + bh, x:x + bw] = (60 + 9 * cls, 200, 37 * cls % 255)
            anns.append({"id": len(anns) + 1, "image_id": i + 1,
                         "category_id": cls + 1,
                         "bbox": [float(x), float(y), float(bw), float(bh)],
                         "area": float(bw * bh), "iscrowd": 0,
                         "difficult": 0})
        frames.append(img)
        images.append({"id": i + 1, "file_name": "{:06d}.jpg".format(i + 1),
                       "width": w, "height": h})
    gt = {"images": images, "annotations": anns,
          "categories": [{"id": j + 1, "name": str(j)} for j in range(20)]}
    return frames, gt


def phase_detector(model, device="cuda"):
    """The served path: CtdetDetector answers 8 per-image flip-test
    requests and one batch-32 request; detections are scored."""
    from codenet_torch import config as cfg
    from codenet_torch.engine.detector import CtdetDetector
    from codenet_torch.eval.voc_eval import voc_eval_from_coco_json
    from codenet_torch.ops import deform_cuda as DC

    opt = cfg.update_dataset_info_and_set_heads(
        cfg.parse(["ctdet", "--dataset", "pascal", "--arch",
                   "shufflenetv2", "--input_res", "256", "--flip_test"]),
        cfg.DATASET_SPECS["pascal"])
    det = CtdetDetector(opt, state_dict=model.state_dict(), device=device)
    frames, gt = synthetic_frames(32)

    DC.LAUNCHES = 0  # counts from here on are the served path's own
    per_image = []
    results = {}
    for i, frame in enumerate(frames[:8]):
        ret = det.run(frame)
        results[i + 1] = ret["results"]
        per_image.append({k: ret[k] for k in ("tot", "load", "pre", "net",
                                              "dec", "post", "merge")})
        per_image[-1]["dets"] = int(sum(len(v) for v in
                                        ret["results"].values()))
    launches_run = DC.LAUNCHES

    pre = [det.pre_process(f, 1) for f in frames]
    stack = np.concatenate([p[0][0:1] for p in pre]
                           + [p[0][1:2] for p in pre], axis=0)
    tis = np.stack([p[1]["trans_inv"] for p in pre])
    batch_ms = []
    for _ in range(4):
        det._sync()
        t0 = time.perf_counter()
        dets = det.process_batch(stack, tis).cpu().numpy()
        batch_ms.append((time.perf_counter() - t0) * 1e3)
    launches = DC.LAUNCHES
    for i in range(32):
        results[i + 1] = det.merge_outputs([det.post_process(dets[i], None)])

    detections = [[[] for _ in range(32)] for _ in range(21)]
    for i in range(32):
        for j in range(1, 21):
            detections[j][i] = results[i + 1][j].tolist()
    ap = voc_eval_from_coco_json(detections, gt,
                                 class_names=[str(j) for j in range(20)],
                                 quiet=True)["AP50"]
    steady = min(batch_ms[1:])
    emit({"phase": "detector", "requests": per_image,
          "batch": 32, "batch_ms": batch_ms,
          "batch_img_per_s": 32 / steady * 1e3,
          "launches_per_image_runs": launches_run,
          "launches": launches, "voc_ap50_random_weights": ap})
    forwards = 8 + len(batch_ms)
    if launches != 3 * forwards or not np.isfinite(dets).all() \
            or dets.shape != (32, opt.K, 6):
        raise SystemExit("detector check failed")
    return launches


# the synthetic sets' frames, by (the dataset's image directory, image id)
FRAMES = {}


def serve_frames_from_memory():
    """Every dataset's `load_image` returns the in-memory frame of FRAMES
    (the card's machine has no cv2 to read files with)."""
    from codenet_torch.data.datasets import BaseDataset
    BaseDataset.load_image = \
        lambda ds, index: FRAMES[ds.img_dir, ds.images[index]]


class SmokeData:
    """A synthetic VOC set for the training phases: `n_train` + `n_val`
    frames (synthetic_frames) held in memory, their annotations written
    under exp/ (the layout data/datasets.py::PascalVOC reads), and every
    dataset's `load_image` overridden to return the in-memory frames."""
    task, name, res = "ctdet", "pascal", RES

    def __init__(self, n_train=64, n_val=8):
        frames, gt = synthetic_frames(n_train + n_val)
        self.data_dir = ROOT / "exp" / "chip_smoke" / "data"
        ann_dir = self.data_dir / "voc" / "annotations"
        ann_dir.mkdir(parents=True, exist_ok=True)
        for name, ids in (("trainval0712", range(1, n_train + 1)),
                          ("test2007", range(n_train + 1,
                                             n_train + n_val + 1))):
            keep = set(ids)
            split = dict(gt, images=[i for i in gt["images"]
                                     if i["id"] in keep],
                         annotations=[a for a in gt["annotations"]
                                      if a["image_id"] in keep])
            (ann_dir / "pascal_{}.json".format(name)).write_text(
                json.dumps(split))
        img_dir = str(self.data_dir / "voc" / "images")
        for img, f in zip(gt["images"], frames):
            FRAMES[img_dir, img["id"]] = f
        serve_frames_from_memory()

    def args(self, batch, *extra):
        return [self.task, "--dataset", self.name, "--arch", "shufflenetv2",
                "--input_res", str(self.res), "--batch_size", str(batch),
                "--num_workers", "8", "--data_dir", str(self.data_dir),
                *extra]

    def opt(self, batch, *extra):
        from codenet_torch import config as cfg
        return cfg.update_dataset_info_and_set_heads(
            cfg.parse(self.args(batch, *extra)),
            cfg.DATASET_SPECS[self.name])

    def dataset(self, opt, split="train"):
        from codenet_torch.data.datasets import get_dataset
        return get_dataset(self.name, self.task)(opt, split)


def coco_frames(n):
    """COCO-sized uint8 BGR frames (640x480 / 480x640) of noise with 1-3
    filled boxes each, and their ground truth twice: COCO instances (80
    classes, COCO's category ids) and person keypoints (every box a
    person with 17 joints inside it, a fifth of them unlabelled)."""
    from codenet_torch.data.datasets import COCO
    rng = np.random.RandomState(SEED + 7)
    frames, images, anns, kanns = [], [], [], []
    for i in range(n):
        w, h = (640, 480) if i % 2 == 0 else (480, 640)
        img = (rng.rand(h, w, 3) * 60).astype(np.uint8)
        for _ in range(rng.randint(1, 4)):
            bw, bh = rng.randint(24, w // 2), rng.randint(24, h // 2)
            x, y = rng.randint(0, w - bw), rng.randint(0, h - bh)
            cls = int(rng.randint(0, 80))
            img[y:y + bh, x:x + bw] = (60 + 2 * cls, 200, 37 * cls % 255)
            ann = {"id": len(anns) + 1, "image_id": i + 1,
                   "category_id": COCO._valid_ids[cls],
                   "bbox": [float(x), float(y), float(bw), float(bh)],
                   "area": float(bw * bh), "iscrowd": 0}
            anns.append(ann)
            vis = rng.choice([0, 2], 17, p=[0.2, 0.8])
            kps = np.stack([x + rng.rand(17) * bw, y + rng.rand(17) * bh,
                            vis], axis=1).reshape(-1)
            kanns.append(dict(ann, category_id=1, keypoints=kps.tolist(),
                              num_keypoints=int((vis > 0).sum())))
        frames.append(img)
        images.append({"id": i + 1, "file_name": "{:012d}.jpg".format(i + 1),
                       "width": w, "height": h})
    cats = [{"id": c, "name": str(c)} for c in COCO._valid_ids]
    return frames, ({"images": images, "annotations": anns,
                     "categories": cats},
                    {"images": images, "annotations": kanns,
                     "categories": [{"id": 1, "name": "person"}]})


def with_extreme_points(boxes):
    """COCO instances with each box's four extreme points (top, left,
    bottom, right: one on each edge, at a seeded place along it), as
    instances_extreme_*.json carries them."""
    rng = np.random.RandomState(SEED + 11)
    anns = []
    for ann in boxes["annotations"]:
        x, y, bw, bh = ann["bbox"]
        u = rng.rand(4)
        anns.append(dict(ann, extreme_points=[
            x + u[0] * bw, y, x, y + u[1] * bh,
            x + u[2] * bw, y + bh, x + bw, y + u[3] * bh]))
    return dict(boxes, annotations=anns)


class CocoSmokeData(SmokeData):
    """A synthetic COCO set for the coco_ctdet, multi_pose and exdet
    phases, at COCO_RES: `n_train` + `n_val` frames (coco_frames) held in
    memory, their instances_*.json (task ctdet), person_keypoints_*.json
    (task multi_pose) or instances_extreme_*.json (task exdet) written
    under exp/ (the layout data/datasets.py::COCO and COCOHP read)."""
    res = COCO_RES

    def __init__(self, task, n_train=64, n_val=8):
        self.task = task
        self.name = "coco_hp" if task == "multi_pose" else "coco"
        frames, (boxes, keypoints) = coco_frames(n_train + n_val)
        gt, prefix = {
            "ctdet": (boxes, "instances"),
            "multi_pose": (keypoints, "person_keypoints"),
            "exdet": (with_extreme_points(boxes), "instances_extreme")}[task]
        self.data_dir = ROOT / "exp" / "chip_smoke" / "data"
        ann_dir = self.data_dir / "coco" / "annotations"
        ann_dir.mkdir(parents=True, exist_ok=True)
        for split, ids in (("train", range(1, n_train + 1)),
                           ("val", range(n_train + 1,
                                         n_train + n_val + 1))):
            keep = set(ids)
            (ann_dir / "{}_{}2017.json".format(prefix, split)).write_text(
                json.dumps(dict(gt, images=[i for i in gt["images"]
                                            if i["id"] in keep],
                                annotations=[a for a in gt["annotations"]
                                             if a["image_id"] in keep])))
            img_dir = str(self.data_dir / "coco" / "{}2017".format(split))
            for img, f in zip(gt["images"], frames):
                if img["id"] in keep:
                    FRAMES[img_dir, img["id"]] = f
        serve_frames_from_memory()


def kitti_frames(n):
    """KITTI-sized uint8 BGR frames (1242x375) of noise, each with 1-4
    objects whose 2D boxes are the projections of seeded 3D boxes: the
    class's mean dimensions, 8-40 m ahead on a ground plane 1.6 m below
    the camera, any yaw, projected through the frame's own P2 (KITTI's,
    its focal length and principal point jittered). Returns the frames,
    COCO-format ground truth with each image's calib and each object's
    alpha, depth and dim (what the ddd sampler reads), and each image's
    KITTI label txt (what the scorer reads)."""
    rng = np.random.RandomState(SEED + 13)
    names = ["Pedestrian", "Car", "Cyclist"]
    dims = {"Pedestrian": (1.76, 0.66, 0.84), "Car": (1.53, 1.63, 3.88),
            "Cyclist": (1.74, 0.60, 1.76)}
    h, w = KITTI_FRAME
    frames, images, anns, labels = [], [], [], []
    for i in range(n):
        f = 707.0493 * rng.uniform(0.97, 1.03)
        calib = np.array([[f, 0, 604.0814 + rng.uniform(-8, 8), 45.75831],
                          [0, f, 180.5066 + rng.uniform(-4, 4), -0.3454157],
                          [0, 0, 1.0, 0.004981016]])
        img = (rng.rand(h, w, 3) * 60).astype(np.uint8)
        lines = []
        for _ in range(rng.randint(1, 5)):
            cls = int(rng.randint(0, 3))
            dh, dw, dl = dims[names[cls]]
            z = rng.uniform(8.0, 40.0)
            x, y = rng.uniform(-0.4, 0.4) * z, 1.6
            ry = rng.uniform(-np.pi, np.pi)
            c, sn = np.cos(ry), np.sin(ry)
            corners = np.array([[c, 0, sn], [0, 1, 0], [-sn, 0, c]]) @ \
                np.array([[dl, dl, -dl, -dl, dl, dl, -dl, -dl],
                          [0, 0, 0, 0, -2 * dh, -2 * dh, -2 * dh, -2 * dh],
                          [dw, -dw, -dw, dw, dw, -dw, -dw, dw]]) / 2
            proj = calib @ np.vstack([corners + [[x], [y], [z]],
                                      np.ones((1, 8))])
            pix = proj[:2] / proj[2:]
            x1, y1 = max(pix[0].min(), 0.0), max(pix[1].min(), 0.0)
            x2, y2 = min(pix[0].max(), w - 1.0), min(pix[1].max(), h - 1.0)
            if x2 - x1 < 8 or y2 - y1 < 8:
                continue
            alpha = (ry - np.arctan2(x, z) + np.pi) % (2 * np.pi) - np.pi
            img[int(y1):int(y2), int(x1):int(x2)] = (60 + 60 * cls, 200,
                                                     37 * cls)
            anns.append({"id": len(anns) + 1, "image_id": i + 1,
                         "category_id": cls + 1,
                         "bbox": [x1, y1, x2 - x1, y2 - y1],
                         "area": (x2 - x1) * (y2 - y1), "iscrowd": 0,
                         "alpha": alpha, "depth": z, "dim": [dh, dw, dl],
                         "rotation_y": ry, "location": [x, y, z]})
            lines.append(" ".join(
                [names[cls], "0.00", "0"] + ["{:.2f}".format(v) for v in (
                    alpha, x1, y1, x2, y2, dh, dw, dl, x, y, z, ry)]))
        frames.append(img)
        images.append({"id": i + 1, "file_name": "{:06d}.png".format(i + 1),
                       "width": w, "height": h, "calib": calib.tolist()})
        labels.append("\n".join(lines) + "\n")
    gt = {"images": images, "annotations": anns,
          "categories": [{"id": j + 1, "name": nm}
                         for j, nm in enumerate(names)]}
    return frames, gt, labels


class KittiSmokeData(SmokeData):
    """A synthetic KITTI set for the ddd phase, at KITTI_HW (the kitti
    dataset's default input): `n_train` + `n_val` frames (kitti_frames)
    held in memory, kitti_3dop_{train,val}.json and the val frames' label
    txts written under exp/ (the layout data/datasets.py::KITTI reads)."""
    task, name = "ddd", "kitti"

    def __init__(self, n_train=32, n_val=8):
        frames, gt, labels = kitti_frames(n_train + n_val)
        self.data_dir = ROOT / "exp" / "chip_smoke" / "data"
        base = self.data_dir / "kitti"
        label_dir = base / "training" / "label_2"
        for d in (base / "annotations", label_dir):
            d.mkdir(parents=True, exist_ok=True)
        for split, ids in (("train", range(1, n_train + 1)),
                           ("val", range(n_train + 1,
                                         n_train + n_val + 1))):
            keep = set(ids)
            (base / "annotations" / "kitti_3dop_{}.json".format(split)) \
                .write_text(json.dumps(dict(
                    gt, images=[i for i in gt["images"] if i["id"] in keep],
                    annotations=[a for a in gt["annotations"]
                                 if a["image_id"] in keep])))
        img_dir = str(base / "images" / "trainval")
        for img, frame, text in zip(gt["images"], frames, labels):
            FRAMES[img_dir, img["id"]] = frame
            (label_dir / "{:06d}.txt".format(img["id"])).write_text(text)
        serve_frames_from_memory()

    def args(self, batch, *extra):
        return [self.task, "--dataset", self.name, "--arch", "shufflenetv2",
                "--batch_size", str(batch), "--num_workers", "8",
                "--data_dir", str(self.data_dir), *extra]


def grads_vs(model, ref_model):
    """Relative L2 error of all parameter gradients; each tensor's error
    relative to that tensor's max (floored at 1e-5 of the largest
    gradient: a BN bias before a train-mode BN has a gradient of rounding
    noise only): the median, the worst, and those of the deform blocks'
    tensors (scale predictor, deform weight, mixer) one by one."""
    num = den = 0.0
    per = {}
    ref = {n: p.grad.detach().double().cpu()
           for n, p in ref_model.named_parameters()}
    gmax = max(float(g.abs().max()) for g in ref.values())
    for name, p in model.named_parameters():
        a = p.grad.detach().double().cpu()
        b = ref[name]
        num += float(((a - b) ** 2).sum())
        den += float((b ** 2).sum())
        per[name] = float((a - b).abs().max()) / max(float(b.abs().max()),
                                                     1e-5 * gmax)
    worst = max(per, key=per.get)
    return {"grad_rel_l2": (num / den) ** 0.5,
            "grad_tensor_rel_median": float(np.median(list(per.values()))),
            "grad_tensor_rel_max": per[worst], "grad_tensor_worst": worst,
            "deform_tensor_rel": {n: e for n, e in per.items()
                                  if n.startswith(DEFORM_PARAMS)}}


def conditioned_init(opt, deform_backbone=False):
    """The port's seeded init (s == 1 in every deform block) with every BN
    bias raised by BN_SHIFT but those before the heads' last convs.

    At the init's zero biases a random network this deep with train-mode
    BN is chaotic in f32, so two correct devices disagree as much as f32
    does from f64. Measured with tools_torch/step_conditioning.py on this
    script's batch (CPU, 256^2, batch 4), f32 against f64: 5.1% relative
    L2 over all gradients from the plain init (median tensor 4.2%, deform
    blocks up to 13%), 7.9e-5 from this one (median 2.3e-4, deform blocks
    up to 4.2e-4). Raised by 3, nearly every ReLU is on its linear side;
    what stays ill-conditioned are a few BN biases whose gradients nearly
    cancel (the worst 5.5% of its own small max). The BNs before the
    heads' last convs keep their biases, so the heatmap logits stay off
    the loss's sigmoid clamp."""
    from codenet_torch.models import create_model
    model = create_model(opt.arch, opt.heads, opt.head_conv, device="cpu",
                         deform_backbone=deform_backbone,
                         generator=torch.Generator().manual_seed(opt.seed))
    keep = {head + ".4" for head in opt.heads}
    with torch.no_grad():
        for name, m in model.named_modules():
            if isinstance(m, torch.nn.BatchNorm2d) and name not in keep:
                m.bias.add_(BN_SHIFT)
    return model.state_dict()


def make_trainer(opt, device, qspec=None, deform_backbone=False):
    """A Trainer for `opt` on `device`; with deform_backbone, on that
    variant (built through create_model: no CLI exposes it, as the JAX
    package's do not)."""
    from codenet_torch.engine.trainer import Trainer
    from codenet_torch.models import create_model
    trainer = Trainer(opt, qspec=qspec, device=device)
    if deform_backbone:
        trainer.model = create_model(
            opt.arch, opt.heads, opt.head_conv, qspec=qspec,
            dtype=opt.dtype, deform_backbone=True, device=device,
            generator=torch.Generator().manual_seed(opt.seed))
    return trainer


def step_parity(data, state_dict, qspec=None, deform_backbone=False,
                bf16=False, batch=4):
    """One train step at `batch` on the card and on the CPU from the same
    weights and batch: the loss, the gradients over all parameters, the
    median tensor and each deform-block tensor (grads_vs), each held at
    STEP_TOL (with bf16 conv operands: the loss at BF16_LOSS_TOL and all
    gradients together at BF16_GRAD_TOL); the step's kernel launches."""
    from codenet_torch.data.loader import DataLoader
    from codenet_torch.engine.trainer import batch_to_device
    from codenet_torch.ops import deform_cuda as DC
    opt = data.opt(batch, *(["--dtype", "bfloat16"] if bf16 else []))
    batch = next(iter(DataLoader(data.dataset(opt), batch, shuffle=True,
                                 num_workers=4, seed=1)))
    card, cpu = (make_trainer(opt, dev, qspec, deform_backbone)
                 for dev in ("cuda", "cpu"))
    card.model.load_state_dict(state_dict)
    cpu.model.load_state_dict(state_dict)
    card.init()
    cpu.init()
    DC.LAUNCHES = DC.BWD_LAUNCHES = 0
    with cudnn_tf32(bf16):
        got = card.train_step(batch_to_device(batch, "cuda"))
        torch.cuda.synchronize()
    launches = (DC.LAUNCHES, DC.BWD_LAUNCHES)
    ref = cpu.train_step(batch_to_device(batch, "cpu"))
    err = grads_vs(card.model, cpu.model)
    out = {"loss_card": float(got["loss"]), "loss_cpu": float(ref["loss"]),
           "loss_rel": abs(float(got["loss"]) - float(ref["loss"]))
           / abs(float(ref["loss"])),
           "launches_fwd_bwd": list(launches), **err}
    calls = 16 if deform_backbone else 3
    if bf16:
        return out, (launches == (calls, calls)
                     and out["loss_rel"] <= BF16_LOSS_TOL
                     and err["grad_rel_l2"] <= BF16_GRAD_TOL)
    ok = (launches == (calls, calls) and out["loss_rel"] <= STEP_TOL
          and err["grad_rel_l2"] <= STEP_TOL
          and err["grad_tensor_rel_median"] <= STEP_TOL
          and len(err["deform_tensor_rel"]) == 12
          and max(err["deform_tensor_rel"].values()) <= STEP_TOL)
    return out, ok


def timed_steps(trainer, batches, cache=None):
    """Train steps on the card, each timed with CUDA events; per-step
    deform launches and losses (timed_steps_in_turns with one path)."""
    return timed_steps_in_turns({"run": (trainer, batches, cache)})["run"]


def timed_steps_in_turns(paths):
    """Train steps on the card, each timed with CUDA events. `paths` maps a
    name to (trainer, batches, cache): step i of every path runs before
    step i + 1 of any, so that the paths compare in turns on one card
    state. Per path: each step's ms, deform launches and loss. Image
    cache batches (img_idx) read the device-resident stack `cache`, as
    Trainer.run_epoch hands it them."""
    from codenet_torch.engine.trainer import batch_size_of, batch_to_device
    from codenet_torch.ops import deform_cuda as DC
    runs = {name: {"ms": [], "losses": [], "per_step": []} for name in paths}
    for i in range(min(len(b) for _, b, _ in paths.values())):
        for name, (trainer, batches, cache) in paths.items():
            dev = batch_to_device(batches[i], "cuda")
            if cache is not None:
                dev["cache_images"] = cache
            torch.cuda.synchronize()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            before = (DC.LAUNCHES, DC.BWD_LAUNCHES)
            start.record()
            stats = trainer.train_step(dev)
            end.record()
            torch.cuda.synchronize()
            run = runs[name]
            run["ms"].append(start.elapsed_time(end))
            run["losses"].append(float(stats["loss"]))
            run["per_step"].append([DC.LAUNCHES - before[0],
                                    DC.BWD_LAUNCHES - before[1]])
    out = {}
    for name, run in runs.items():
        steady = float(np.median(run["ms"][1:]))
        batch = batch_size_of(paths[name][1][0])
        out[name] = {
            "steps": len(run["ms"]), "batch": batch,
            "ms_per_step": run["ms"], "ms_per_step_steady_median": steady,
            "img_per_s": batch / steady * 1e3,
            "losses": run["losses"],
            "launches_fwd": sum(p[0] for p in run["per_step"]),
            "launches_bwd": sum(p[1] for p in run["per_step"]),
            "launches_per_step": run["per_step"]}
    return out


def phase_train(data):
    """FP32 training: one step card vs CPU at batch 4; then 12 steps at
    batch 32 on port-sampler batches, the loader timed separately."""
    from codenet_torch.data.loader import DataLoader
    from codenet_torch.engine.trainer import Trainer
    opt = data.opt(TRAIN_BATCH)
    parity, ok = step_parity(data, conditioned_init(opt))
    emit({"phase": "train_parity", "batch": 4, "bn_shift": BN_SHIFT,
          **parity, "tol": STEP_TOL})
    if not ok:
        raise SystemExit("train parity check failed")

    loader = DataLoader(data.dataset(opt), TRAIN_BATCH, shuffle=True,
                        num_workers=opt.num_workers, seed=opt.seed)
    t0 = time.perf_counter()
    batches = []
    while len(batches) < 12:
        batches.extend(loader)
    loader_ms = (time.perf_counter() - t0) * 1e3 / len(batches)
    batches = batches[:12]
    trainer = Trainer(opt, device="cuda")
    trainer.init()
    run = timed_steps(trainer, batches)
    run.update(loader_ms_per_batch=loader_ms, loader_workers=opt.num_workers)
    emit({"phase": "train", **run})
    if not np.all(np.isfinite(run["losses"])) or any(
            s != [3, 3] for s in run["launches_per_step"]):
        raise SystemExit("train check failed")
    return trainer, batches, run


def phase_qat(data, fp32_trainer, batches):
    """QAT: one step card vs CPU at batch 4 from the conditioned init;
    then the trained FP32 weights through the port's checkpoint into the
    quantized model, 6 timed steps at batch 32 (ranges finite and moving),
    and a fake-quant CtdetDetector eval of the 8 val frames.

    The parity step does not start from the trained weights: twelve FP32
    steps end at another point in every run (the deform backward sums
    with atomics in no fixed order, and Adam turns that noise into whole
    steps on the parameters whose gradient is nearly 0), and from most
    such points one rounding of a fake quantizer that goes the other way
    on the card moves some gradients by percents
    (tools_torch/qat_parity_starts.py). From the conditioned init it
    does not."""
    from codenet_torch.engine import checkpoint
    from codenet_torch.engine.detector import CtdetDetector
    from codenet_torch.engine.trainer import Trainer
    from codenet_torch.models import create_model
    from codenet_torch.models.layers import QuantSpec
    from codenet_torch.ops import deform_cuda as DC
    path = str(ROOT / "exp" / "chip_smoke" / "fp32.pth")
    checkpoint.save_model(path, 1, fp32_trainer.model,
                          fp32_trainer.optimizer)
    qspec = QuantSpec()
    opt = data.opt(TRAIN_BATCH)
    trainer = Trainer(opt, qspec=qspec, device="cuda")
    log = io.StringIO()
    with contextlib.redirect_stdout(log):
        _, epoch = checkpoint.load_model(path, trainer.model)
    missing = sum(ln.startswith("No param") for ln in log.getvalue()
                  .splitlines())
    trainer.init()

    start = create_model(opt.arch, opt.heads, opt.head_conv, qspec=qspec,
                         device="cpu")
    start.load_state_dict(conditioned_init(opt), strict=False)
    parity, ok = step_parity(data, start.state_dict(), qspec)
    emit({"phase": "qat_parity", "batch": 4, **parity, "tol": STEP_TOL})
    if not ok:
        raise SystemExit("qat parity check failed")

    before = {k: v.clone() for k, v in trainer.model.state_dict().items()
              if k.endswith(("x_min", "x_max"))}
    run = timed_steps(trainer, batches[:6])
    after = {k: v for k, v in trainer.model.state_dict().items()
             if k in before}
    finite = all(bool(torch.isfinite(v).all()) for v in after.values())
    moved = sum(not torch.equal(after[k], before[k]) for k in before
                if k.endswith("x_max"))

    eval_opt = data.opt(1, "--flip_test", "--resume-quantize")
    det = CtdetDetector(eval_opt, state_dict=trainer.model.state_dict(),
                        device="cuda")
    val = data.dataset(eval_opt, "val")
    DC.LAUNCHES = 0
    dets = [det.run(val.load_image(i))["results"] for i in range(len(val))]
    eval_launches = DC.LAUNCHES
    n_dets = [int(sum(len(v) for v in r.values())) for r in dets]
    dets_finite = all(np.isfinite(v).all() for r in dets for v in r.values())
    emit({"phase": "qat", "checkpoint_epoch": epoch,
          "ranges_missing_in_fp32_ckpt": missing, **run,
          "ranges_finite": finite, "ranges_moved": moved,
          "eval_images": len(dets), "eval_dets": n_dets,
          "eval_launches": eval_launches})
    if (missing != 110 or not finite or moved != 55
            or not np.all(np.isfinite(run["losses"]))
            or any(s != [3, 3] for s in run["launches_per_step"])
            or eval_launches != 3 * len(dets) or not dets_finite):
        raise SystemExit("qat check failed")
    return run, eval_launches, trainer.model


def phase_cli(data):
    """python -m codenet_torch.cli.main then cli.quant_main from its
    checkpoint, 2 iterations each at batch 32, each ending in its
    detection eval of the val frames; then the same two with --dtype
    bfloat16, and cli.test --dtype bfloat16 --resume-quantize, fake-quant
    and --int8_infer, on the bf16 QAT checkpoint. Returns the (forward,
    backward) launches of the bf16 runs."""
    from codenet_torch.cli import main as cli_main
    from codenet_torch.cli import quant_main
    from codenet_torch.cli import test as cli_test
    from codenet_torch.ops import deform_cuda as DC
    common = ["--num_epochs", "1", "--num_iters", "2", "--lr_step", "1",
              "--val_intervals", "-1", "--print_iter", "1"]

    def ckpt(exp_id):
        return str(ROOT / "exp" / "ctdet" / exp_id / "model_last.pth")
    bf16 = ["--dtype", "bfloat16"]
    quant = ["--resume-quantize", "--load_model", ckpt("chip_smoke_qat_bf16")]
    # (name, entry point, batch, arguments, bf16, forward launches or
    # None, backward launches): training runs 2 steps, evals 8 frames
    runs = [("main", cli_main.main, TRAIN_BATCH,
             common + ["--exp_id", "chip_smoke_fp32"], False, None, 6),
            ("quant_main", quant_main.main, TRAIN_BATCH,
             common + ["--exp_id", "chip_smoke_qat", "--load_model",
                       ckpt("chip_smoke_fp32")], False, None, 6),
            ("main_bf16", cli_main.main, TRAIN_BATCH,
             common + bf16 + ["--exp_id", "chip_smoke_fp32_bf16"], True,
             None, 6),
            ("quant_main_bf16", quant_main.main, TRAIN_BATCH,
             common + bf16 + ["--exp_id", "chip_smoke_qat_bf16",
                              "--load_model", ckpt("chip_smoke_fp32_bf16")],
             True, None, 6),
            ("test_fake_quant_bf16", cli_test.main, 1,
             bf16 + quant + ["--exp_id", "chip_smoke_fq_bf16"], True, 24, 0),
            # from the .pth one more forward derives the integer weights
            ("test_int8_bf16", cli_test.main, 1,
             bf16 + quant + ["--int8_infer", "--exp_id",
                             "chip_smoke_int8_bf16"], True, 27, 0)]
    out = {"phase": "cli"}
    bf16_launches = [0, 0]
    for name, fn, batch, args, on, fwd, bwd in runs:
        DC.LAUNCHES = DC.BWD_LAUNCHES = 0
        log = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(log), cudnn_tf32(on):
            fn(data.args(batch, *args))
        text = log.getvalue()
        losses = [float(ln.split(" loss ")[1].split()[0])
                  for ln in text.splitlines()
                  if ln.startswith("train epoch")]
        ap = [ln for ln in text.splitlines() if "Mean AP" in ln]
        out[name] = {"seconds": time.perf_counter() - t0, "losses": losses,
                     "lr_dropped": "Drop LR to" in text,
                     "mean_ap_line": ap[-1].strip() if ap else None,
                     "launches_fwd": DC.LAUNCHES,
                     "launches_bwd": DC.BWD_LAUNCHES}
        if on:
            bf16_launches[0] += DC.LAUNCHES
            bf16_launches[1] += DC.BWD_LAUNCHES
        trains = fn is not cli_test.main
        if (len(losses) != (2 if trains else 0) or not ap
                or not np.all(np.isfinite(losses))
                or DC.BWD_LAUNCHES != bwd
                or fwd is not None and DC.LAUNCHES != fwd):
            emit(out)
            raise SystemExit("cli {} check failed".format(name))
    emit(out)
    return bf16_launches


def head_errs(ref, out):
    """Each head's max |difference| over its max |value|."""
    return {k: float((out[k].cpu() - ref[k].cpu()).abs().max())
            / float(ref[k].abs().max()) for k in ref}


def head_rel_l2(ref, out):
    """Each head's relative L2 difference."""
    return {k: float((out[k].cpu() - ref[k].cpu()).norm()
                     / ref[k].cpu().norm()) for k in ref}


@contextlib.contextmanager
def recording(module, name, record):
    """Within the block, `module.name(*args)` calls record(*args) first."""
    fn = getattr(module, name)

    def wrapped(*args):
        record(*args)
        return fn(*args)
    setattr(module, name, wrapped)
    try:
        yield
    finally:
        setattr(module, name, fn)


def int8_exactness(model, x):
    """Every int8 conv of one forward of `model` on x: the card's
    accumulator and zero-point factor against the exact f64 ones of the
    same integers on the CPU. Returns (convs, shapes, mismatches)."""
    from codenet_torch.ops import quant as Q
    calls = []
    with recording(Q, "int8_conv", lambda *a: calls.append(a)), \
            torch.no_grad():
        model(x)
    shapes, bad = set(), []
    for qx, q_w, _, _, *args in calls:
        acc, wsum = Q.int8_conv_terms(qx.values, q_w, *args)
        ref_acc, ref_wsum = Q.int8_conv_terms(qx.values.cpu().double(),
                                              q_w.cpu().double(), *args)
        shape = (tuple(qx.values.shape), tuple(q_w.shape), *args)
        shapes.add(shape)
        if not (torch.equal(acc.cpu().double(), ref_acc)
                and torch.equal(wsum.cpu().double(), ref_wsum)):
            bad.append(str(shape))
    return len(calls), len(shapes), bad


def phase_int8(data, qat_model, bw, flops):
    """Real-int8 eval of the QAT-trained model (phase_qat) and of the CLI's
    QAT checkpoint (phase_cli). Returns (served launches, CLI launches,
    kernels-line fields of the bf16 forward)."""
    import importlib.util
    from codenet_torch.cli import test as cli_test
    from codenet_torch.engine import checkpoint
    from codenet_torch.engine.detector import CtdetDetector, eval_input
    from codenet_torch.models import create_model
    from codenet_torch.models import layers as L
    from codenet_torch.models.layers import QuantSpec
    from codenet_torch.ops import deform_cuda as DC
    out = {"phase": "int8"}
    fail = []
    work = ROOT / "exp" / "chip_smoke"
    pth, art = str(work / "qat.pth"), str(work / "qat_w4a8.npz")
    checkpoint.save_model(pth, 1, qat_model, qspec=QuantSpec())
    spec = importlib.util.spec_from_file_location(
        "export_w4a8", ROOT / "tools_torch" / "export_w4a8.py")
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    log = io.StringIO()
    with contextlib.redirect_stdout(log):
        rc = tool.main(data.args(1, "--resume-quantize", "--load_model",
                                 pth, "--out", art))
    out["artifact_bytes"] = Path(art).stat().st_size
    out["export_log"] = log.getvalue().splitlines()[-1]
    if rc != 0:
        fail.append("export")

    def detector(*extra):
        return CtdetDetector(data.opt(1, "--flip_test", "--resume-quantize",
                                      "--int8_infer", *extra), device="cuda")
    dets = {"pth": detector("--load_model", pth),
            "artifact": detector("--w4a8_artifact", art)}
    val = data.dataset(data.opt(1), "val")
    frames = [val.load_image(i) for i in range(len(val))]
    kernel_dtypes = []
    results, net_ms = {}, {}
    with recording(DC, "_launch",
                   lambda x, s, w: kernel_dtypes.append(str(x.dtype))):
        DC.LAUNCHES = 0  # counts from here on are the served path's own
        for name, det in dets.items():
            rets = [det.run(f) for f in frames]
            results[name] = [r["results"] for r in rets]
            net_ms[name] = [r["net"] * 1e3 for r in rets]
        served = DC.LAUNCHES
    forwards = len(dets) * len(frames)
    same = all(np.array_equal(a[j], b[j])
               for a, b in zip(results["pth"], results["artifact"])
               for j in a)
    out.update(requests=forwards, launches=served,
               launch_dtypes=sorted(set(kernel_dtypes)),
               dets_equal=same, net_ms=net_ms,
               dets=[int(sum(len(v) for v in r.values()))
                     for r in results["pth"]])
    if served != 3 * forwards or set(kernel_dtypes) != {"torch.bfloat16"}:
        fail.append("launches")
    if not same:
        fail.append("pth vs artifact detections")

    # one flip-test request (batch 2): card vs CPU, int8 vs fake-quant
    det = dets["pth"]
    images, _ = det.pre_process(frames[0], 1)
    x = eval_input(det._to_device(images), det.mean, det.std)
    model = det.model
    fake = create_model("shufflenetv2", dict(data.opt(1).heads), 64,
                        qspec=QuantSpec(act_clamp=True), device="cuda")
    fake.load_state_dict(model.state_dict())
    deform_args = []
    with torch.no_grad():
        with recording(L, "codesign_deform_conv_fast",
                       lambda *a: deform_args.append(a)):
            card = model(x)
        cpu = copy.deepcopy(model).cpu()(x.cpu())
        ref = fake(x)
        L.INT8_SAMPLE_DTYPE = torch.float32
        try:
            f32 = model(x)
        finally:
            L.INT8_SAMPLE_DTYPE = torch.bfloat16
    out["card_vs_cpu"] = head_errs(cpu, card)
    out["int8_vs_act_clamp"] = head_errs(ref, card)
    out["int8_f32_sampling_vs_act_clamp"] = head_errs(ref, f32)
    out["rel_l2"] = {"card_vs_cpu": head_rel_l2(cpu, card),
                     "int8_vs_act_clamp": head_rel_l2(ref, card),
                     "int8_f32_sampling_vs_act_clamp": head_rel_l2(ref, f32)}
    out["heads_finite"] = all(bool(torch.isfinite(v).all())
                              for v in card.values())
    if not out["heads_finite"] or any(
            max(out[k].values()) > INT8_TOL
            for k in ("card_vs_cpu", "int8_vs_act_clamp",
                      "int8_f32_sampling_vs_act_clamp")):
        fail.append("heads")
    convs, shapes, bad = int8_exactness(model, x)
    out.update(int8_convs=convs, int8_conv_shapes=shapes,
               int8_conv_inexact=bad)
    if bad or convs != 70:
        fail.append("int8 conv exactness")

    # the int8 forward of one request as served (integer weights derived
    # once), with them derived on every call, and the fake-quant (the
    # recipe's) forward; the three bf16 deform calls of the int8 one,
    # weight cast included
    def twin(qspec):
        m = create_model("shufflenetv2", dict(data.opt(1).heads), 64,
                         qspec=qspec, device="cuda")
        m.load_state_dict(model.state_dict())
        return m
    served_fake, derived = twin(QuantSpec()), twin(QuantSpec(int8_infer=True))
    with torch.no_grad():
        out["net_forward_ms"] = {
            "int8": cuda_time_ms(lambda: model(x), 20),
            "int8_derived_per_call": cuda_time_ms(lambda: derived(x), 20),
            "fake_quant": cuda_time_ms(lambda: served_fake(x), 20),
            "int8_again": cuda_time_ms(lambda: model(x), 20)}
        bf16_ms = graph_time_ms(
            lambda: [DC.codesign_deform_conv_fast(*a) for a in deform_args],
            200)
    # x read and the output written in bf16, s in f32, the bf16 weight
    nbytes = sum(2 * a[0].numel() * 2 + a[1].numel() * 4
                 + a[2].numel() * 2 for a in deform_args)
    ops = sum(a[0].numel() * FLOPS_PER_OUT for a in deform_args)
    bf16 = {"ms_int8_forward_bf16": bf16_ms,
            "bound_ms_int8_forward_bf16": max(nbytes / bw, ops / flops)
            * 1e3,
            "int8_deform_shapes": [list(a[0].shape) for a in deform_args]}
    out.update(bf16)

    # the CLI: cli.test --int8_infer on phase_cli's QAT checkpoint, and on
    # its artifact written by the export tool
    qat_ckpt = str(ROOT / "exp" / "ctdet" / "chip_smoke_qat"
                   / "model_last.pth")
    cli_art = str(work / "cli_w4a8.npz")
    with contextlib.redirect_stdout(io.StringIO()):
        rc = tool.main(data.args(1, "--resume-quantize", "--load_model",
                                 qat_ckpt, "--out", cli_art))
    cli_launches = 0
    out["cli"] = {}
    for name, extra in (("pth", ["--load_model", qat_ckpt]),
                        ("artifact", ["--w4a8_artifact", cli_art])):
        log = io.StringIO()
        DC.LAUNCHES = 0
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(log):
            cli_test.main(data.args(1, "--resume-quantize", "--int8_infer",
                                    "--exp_id", "chip_smoke_int8_" + name,
                                    *extra))
        ap = [ln for ln in log.getvalue().splitlines() if "Mean AP" in ln]
        out["cli"][name] = {"seconds": time.perf_counter() - t0,
                            "mean_ap_line": ap[-1].strip() if ap else None,
                            "launches": DC.LAUNCHES}
        cli_launches += DC.LAUNCHES
        # from the .pth, one more forward derives the integer weights
        forwards = len(frames) + (name == "pth")
        if not ap or DC.LAUNCHES != 3 * forwards or rc != 0:
            fail.append("cli " + name)
    out["failed"] = fail
    emit(out)
    if fail:
        raise SystemExit("int8 check failed: {}".format(fail))
    return served, cli_launches, bf16


def _cli_log(fn, argv):
    """Run a CLI entry point with its stdout captured: (text, seconds)."""
    log = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(log):
        fn(argv)
    return log.getvalue(), time.perf_counter() - t0


def _lines_with(text, word):
    return [ln.strip() for ln in text.splitlines() if word in ln]


def phase_devcache(data, train_run, host_batches):
    """Training from the image cache (--device_cache): the 64 train frames
    on the card; one --no_color_aug batch through the cache path against
    the host path (same rng: equal targets, the unrounded warp within
    half a level of the host's uint8 pixels); the cache loader timed
    beside the train phase's host loader; 12 FP32 steps at batch 32 from
    the cache in turns with 12 on the train phase's host batches (two
    trainers from one init), and the model input of one batch of each
    (colour aug and normalise; the cache's gather and warp too); then
    `cli.main --device_cache` for one short epoch and its final eval.
    Returns the (forward, backward) launches of its training paths."""
    from codenet_torch.cli import main as cli_main
    from codenet_torch.data.affine import warp_affine_batch
    from codenet_torch.data.device_aug import model_input
    from codenet_torch.data.device_cache import ImageCache
    from codenet_torch.data.loader import DataLoader
    from codenet_torch.engine.trainer import Trainer, batch_to_device
    from codenet_torch.ops import deform_cuda as DC
    out = {"phase": "devcache"}
    fail = []
    opt = data.opt(TRAIN_BATCH, "--device_cache")
    ds = data.dataset(opt)
    t0 = time.perf_counter()
    cache = ImageCache.build(ds)
    t1 = time.perf_counter()
    stack = cache.to_device("cuda")
    torch.cuda.synchronize()
    out.update(images=len(ds), stack_shape=list(stack.shape),
               stack_bytes=cache.nbytes, build_ms=(t1 - t0) * 1e3,
               upload_ms=(time.perf_counter() - t1) * 1e3)
    ds._image_cache_dims = cache.dims

    host_ds = data.dataset(data.opt(TRAIN_BATCH, "--no_color_aug"))
    cache_ds = data.dataset(data.opt(TRAIN_BATCH, "--no_color_aug",
                                     "--device_cache"))
    cache_ds._image_cache_dims = cache.dims
    host, cached = (next(iter(DataLoader(d, TRAIN_BATCH, shuffle=True,
                                         num_workers=8, seed=2)))
                    for d in (host_ds, cache_ds))
    same = [k for k in host if k != "input_u8"
            and np.array_equal(host[k], cached[k])]
    warped = warp_affine_batch(
        stack, torch.from_numpy(cached["warp_ti"]).cuda(), RES, RES,
        rows=torch.from_numpy(cached["img_idx"]).cuda())
    pixel_err = float((warped.cpu() - torch.from_numpy(host["input_u8"])
                       .float()).abs().max())
    out.update(targets_equal=len(same) == len(host) - 1,
               warped_vs_host_u8_max_err=pixel_err,
               warped_tol=CACHE_PIXEL_TOL)
    if len(same) != len(host) - 1 or not pixel_err <= CACHE_PIXEL_TOL:
        fail.append("cache batch vs host batch")

    loader = DataLoader(ds, TRAIN_BATCH, shuffle=True,
                        num_workers=opt.num_workers, seed=opt.seed)
    t0 = time.perf_counter()
    batches = []
    while len(batches) < 12:
        batches.extend(loader)
    out["loader_ms_per_batch"] = (time.perf_counter() - t0) * 1e3 \
        / len(batches)
    out["host_loader_ms_per_batch"] = train_run["loader_ms_per_batch"]
    trainer = Trainer(opt, device="cuda")
    trainer.init()
    host_trainer = Trainer(data.opt(TRAIN_BATCH), device="cuda")
    host_trainer.init()
    runs = timed_steps_in_turns({
        "cache": (trainer, batches[:12], stack),
        "host": (host_trainer, host_batches[:12], None)})
    out["steps_in_turns"] = runs
    out["train_phase_ms_per_step_steady_median"] = \
        train_run["ms_per_step_steady_median"]
    for run in runs.values():
        if not np.all(np.isfinite(run["losses"])) or any(
                s != [3, 3] for s in run["launches_per_step"]):
            fail.append("steps")
    cache_batch = batch_to_device(batches[0], "cuda")
    host_batch = batch_to_device(host_batches[0], "cuda")
    out["model_input_ms"] = {
        "cache": cuda_time_ms(lambda: model_input(
            cache_batch, trainer.mean, trainer.std, (RES, RES), stack), 20),
        "host": cuda_time_ms(lambda: model_input(
            host_batch, trainer.mean, trainer.std), 20)}

    DC.LAUNCHES = DC.BWD_LAUNCHES = 0
    text, seconds = _cli_log(cli_main.main, data.args(
        TRAIN_BATCH, "--device_cache", "--num_epochs", "1", "--num_iters",
        "2", "--val_intervals", "-1", "--print_iter", "1", "--exp_id",
        "chip_smoke_devcache"))
    losses = [float(ln.split(" loss ")[1].split()[0])
              for ln in _lines_with(text, "train epoch")]
    ap = _lines_with(text, "Mean AP")
    out["cli"] = {"seconds": seconds, "losses": losses,
                  "cache_line": (_lines_with(text, "device_cache:")
                                 or [None])[0],
                  "mean_ap_line": ap[-1] if ap else None,
                  "launches_fwd": DC.LAUNCHES,
                  "launches_bwd": DC.BWD_LAUNCHES}
    # two steps, then the final eval's 8 flip-less requests
    if (len(losses) != 2 or not np.all(np.isfinite(losses)) or not ap
            or not out["cli"]["cache_line"] or DC.BWD_LAUNCHES != 6
            or DC.LAUNCHES != 6 + 3 * 8):
        fail.append("cli")
    out["failed"] = fail
    emit(out)
    if fail:
        raise SystemExit("devcache check failed: {}".format(fail))
    return (sum(r["launches_fwd"] for r in runs.values()) + DC.LAUNCHES,
            sum(r["launches_bwd"] for r in runs.values()) + DC.BWD_LAUNCHES)


def _results_json(exp_id):
    return json.loads((ROOT / "exp" / "ctdet" / exp_id / "results.json")
                      .read_text())


def phase_eval_paths(data, model):
    """`cli.test --batch_eval 32 --flip_test` over the 8 val frames three
    ways, from the served model's weights: the host warp, --device_warp
    and --device_cache. Cached detections equal the device warp's; the
    device warp's match the host warp's for MATCH_SHARE of the boxes.
    Returns the forward launches."""
    from codenet_torch.cli import test as cli_test
    from codenet_torch.engine import checkpoint
    from codenet_torch.ops import deform_cuda as DC
    path = str(ROOT / "exp" / "chip_smoke" / "served.pth")
    checkpoint.save_model(path, 0, model)
    out = {"phase": "eval_paths"}
    fail = []
    res = {}
    launches = 0
    for name, extra in (("host", []), ("device_warp", ["--device_warp"]),
                        ("device_cache", ["--device_cache"])):
        DC.LAUNCHES = 0
        exp_id = "chip_smoke_eval_" + name
        text, seconds = _cli_log(cli_test.main, data.args(
            1, "--batch_eval", "32", "--flip_test", "--load_model", path,
            "--exp_id", exp_id, *extra))
        res[name] = _results_json(exp_id)
        ap = _lines_with(text, "Mean AP")
        out[name] = {"seconds": seconds, "launches": DC.LAUNCHES,
                     "batched": _lines_with(text, "batched eval:"),
                     "stages": _lines_with(text, "stages (s)"),
                     "device_lines": _lines_with(text, "device_"),
                     "mean_ap_line": ap[-1] if ap else None}
        launches += DC.LAUNCHES
        # 8 frames in one batch of 32 (64 forwards with the flipped copies)
        if DC.LAUNCHES != 3 or not ap:
            fail.append(name)
    if not any("0 of 8 frames" in ln
               for ln in out["device_warp"]["device_lines"]):
        fail.append("device_warp took the host warp")
    matched = total = 0
    cache_equal = True
    for cls in range(1, 21):
        for h, w, c in zip(res["host"][cls], res["device_warp"][cls],
                           res["device_cache"][cls]):
            h, w, c = (np.asarray(d, np.float32).reshape(-1, 5)
                       for d in (h, w, c))
            total += len(h)
            if w.shape != c.shape or not np.allclose(c, w, rtol=1e-5,
                                                     atol=1e-4):
                cache_equal = False
            if h.shape == w.shape:
                matched += int(((np.abs(h[:, :4] - w[:, :4]).max(axis=1)
                                 <= WARP_BOX_TOL)
                                & (np.abs(h[:, 4] - w[:, 4])
                                   <= WARP_SCORE_TOL)).sum())
    out.update(boxes=total, device_warp_vs_host_matched=matched,
               device_warp_vs_host_share=matched / max(total, 1),
               cache_equals_device_warp=cache_equal, failed=fail)
    if not cache_equal:
        fail.append("cache vs device_warp")
    if total == 0 or matched / total < MATCH_SHARE:
        fail.append("device_warp vs host")
    emit(out)
    if fail:
        raise SystemExit("eval_paths check failed: {}".format(fail))
    return launches


def _match_share(ref, out):
    """(matched, total) merged boxes of `out` within BOX_TOL px and
    SCORE_TOL of `ref`, class by class (a class whose counts differ
    matches nothing)."""
    matched = total = 0
    for j in ref:
        a, b = ref[j], out[j]
        total += len(a)
        if a.shape == b.shape and len(a):
            matched += int(((np.abs(a[:, :4] - b[:, :4]).max(axis=1)
                             <= BOX_TOL)
                            & (np.abs(a[:, 4] - b[:, 4]) <= SCORE_TOL)).sum())
    return matched, total


def phase_multiscale(model, frames):
    """8 per-image flip-test requests at the five test scales, merged by
    soft-NMS, two ways: --nms at fix_res RES^2, and --keep_res (each
    frame at its own size, rounded up to a multiple of 32). Per request
    the stage timers and the largest per-class box count soft-NMS saw;
    the first CPU_REQUESTS requests also answered by the CPU port from
    the same weights and frames, MATCH_SHARE of the merged boxes held to
    BOX_TOL and SCORE_TOL. Returns the forward launches."""
    from codenet_torch import config as cfg
    from codenet_torch.engine.detector import CtdetDetector
    from codenet_torch.ops import deform_cuda as DC
    out = {"phase": "multiscale", "scales": TEST_SCALES}
    fail = []
    launches = 0
    for name, extra in (("nms", ["--nms"]), ("keep_res", ["--keep_res"])):
        opt = cfg.update_dataset_info_and_set_heads(
            cfg.parse(["ctdet", "--dataset", "pascal", "--arch",
                       "shufflenetv2", "--input_res", str(RES),
                       "--flip_test", "--test_scales", TEST_SCALES,
                       *extra]),
            cfg.DATASET_SPECS["pascal"])
        card = CtdetDetector(opt, state_dict=model.state_dict(),
                             device="cuda")
        cpu = CtdetDetector(opt, state_dict=model.state_dict(), device="cpu")
        merged = card.merge_outputs
        per_class = []

        def record(detections, merged=merged, per_class=per_class):
            per_class.append(max(sum(len(d[j]) for d in detections)
                                 for j in detections[0]))
            return merged(detections)
        card.merge_outputs = record
        DC.LAUNCHES = 0
        rets = [card.run(f) for f in frames]
        run_launches = DC.LAUNCHES
        launches += run_launches
        matched = total = 0
        for f, ret in zip(frames[:CPU_REQUESTS], rets):
            m, t = _match_share(cpu.run(f)["results"], ret["results"])
            matched += m
            total += t
        requests = [{k: ret[k] * 1e3 for k in ("tot", "pre", "net", "dec",
                                               "post", "merge")}
                    for ret in rets]
        for req, ret, n in zip(requests, rets, per_class):
            req["dets"] = int(sum(len(v) for v in ret["results"].values()))
            req["largest_class_boxes"] = n
        finite = all(np.isfinite(v).all() for ret in rets
                     for v in ret["results"].values())
        out[name] = {"requests_ms": requests, "launches": run_launches,
                     "card_vs_cpu_requests": CPU_REQUESTS,
                     "card_vs_cpu_boxes": total,
                     "card_vs_cpu_matched": matched,
                     "card_vs_cpu_share": matched / max(total, 1)}
        scales = len(TEST_SCALES.split(","))
        if run_launches != 3 * scales * len(frames) or not finite:
            fail.append(name + " launches or values")
        if total == 0 or matched / total < MATCH_SHARE:
            fail.append(name + " card vs cpu")
    out.update(tol={"share": MATCH_SHARE, "box_px": BOX_TOL,
                    "score": SCORE_TOL}, failed=fail)
    emit(out)
    if fail:
        raise SystemExit("multiscale check failed: {}".format(fail))
    return launches


def _served_opt(*extra):
    from codenet_torch import config as cfg
    return cfg.update_dataset_info_and_set_heads(
        cfg.parse(["ctdet", "--dataset", "pascal", "--arch",
                   "shufflenetv2", "--input_res", str(RES), "--flip_test",
                   *extra]), cfg.DATASET_SPECS["pascal"])


def phase_bf16(model, data):
    """Serving with bf16 conv operands (--dtype bfloat16) from the served
    model's weights: one flip-test request's heads, card vs CPU port
    (held at BF16_HEAD_TOL) and card bf16 vs card f32 (reported); 8
    per-image flip-test requests and 4 batch-32 requests, bf16 and f32 in
    turns, with the forward launches by dtype; one --nms request at the
    five test scales and `cli.test --batch_eval 32 --device_warp
    --flip_test`, both in bf16. Returns (launches, the bf16 and f32
    timings)."""
    from codenet_torch.cli import test as cli_test
    from codenet_torch.engine import checkpoint
    from codenet_torch.engine.detector import CtdetDetector, eval_input
    from codenet_torch.ops import deform_cuda as DC
    out = {"phase": "bf16", "bf16_cudnn_allow_tf32": True}
    fail = []
    sd = model.state_dict()
    bf16 = ("--dtype", "bfloat16")
    dets = {"bf16": CtdetDetector(_served_opt(*bf16), state_dict=sd,
                                  device="cuda"),
            "f32": CtdetDetector(_served_opt(), state_dict=sd,
                                 device="cuda")}
    cpu = CtdetDetector(_served_opt(*bf16), state_dict=sd, device="cpu")
    frames, _ = synthetic_frames(32)
    det = dets["bf16"]
    images, _ = det.pre_process(frames[0], 1)
    x = eval_input(det._to_device(images), det.mean, det.std)
    with torch.no_grad():
        with cudnn_tf32(True):
            card = det.model(x)
        f32 = dets["f32"].model(x)
        ref = cpu.model(x.cpu())
    out["card_vs_cpu"] = head_errs(ref, card)
    out["card_bf16_vs_card_f32"] = head_errs(f32, card)
    out["rel_l2"] = {"card_vs_cpu": head_rel_l2(ref, card),
                     "card_bf16_vs_card_f32": head_rel_l2(f32, card)}
    out["tol"] = BF16_HEAD_TOL
    if not all(bool(torch.isfinite(v).all()) for v in card.values()) \
            or max(out["card_vs_cpu"].values()) > BF16_HEAD_TOL:
        fail.append("heads")

    dtypes = []
    timings = {name: {"net_ms": [], "tot_ms": [], "batch_ms": []}
               for name in dets}
    pre = [det.pre_process(f, 1) for f in frames]
    stack = np.concatenate([p[0][0:1] for p in pre]
                           + [p[0][1:2] for p in pre], axis=0)
    tis = np.stack([p[1]["trans_inv"] for p in pre])
    with recording(DC, "_launch",
                   lambda x, s, w: dtypes.append(str(x.dtype))):
        DC.LAUNCHES = 0  # counts from here on are the served paths' own
        for f in frames[:8]:
            for name, d in dets.items():
                with cudnn_tf32(name == "bf16"):
                    ret = d.run(f)
                timings[name]["net_ms"].append(ret["net"] * 1e3)
                timings[name]["tot_ms"].append(ret["tot"] * 1e3)
        for _ in range(4):
            for name, d in dets.items():
                with cudnn_tf32(name == "bf16"):
                    d._sync()
                    t0 = time.perf_counter()
                    got = d.process_batch(stack, tis).cpu().numpy()
                timings[name]["batch_ms"].append(
                    (time.perf_counter() - t0) * 1e3)
                if not np.isfinite(got).all():
                    fail.append("batch " + name)
        launches = DC.LAUNCHES
    for t in timings.values():
        t["batch_img_per_s"] = 32 / min(t["batch_ms"][1:]) * 1e3
    out.update(timings=timings, launches=launches,
               launches_bf16=dtypes.count("torch.bfloat16"),
               launches_f32=dtypes.count("torch.float32"))
    # 8 requests and 4 batches, each path 3 launches a forward
    if launches != 2 * 3 * 12 or out["launches_bf16"] != 3 * 12:
        fail.append("launches")

    DC.LAUNCHES = 0
    nms = CtdetDetector(_served_opt(*bf16, "--test_scales", TEST_SCALES,
                                    "--nms"), state_dict=sd, device="cuda")
    with cudnn_tf32(True):
        ret = nms.run(frames[0])
    out["nms_request_ms"] = {k: ret[k] * 1e3 for k in (
        "tot", "pre", "net", "dec", "post", "merge")}
    out["nms_launches"] = DC.LAUNCHES
    if DC.LAUNCHES != 3 * len(TEST_SCALES.split(",")) or not all(
            np.isfinite(v).all() for v in ret["results"].values()):
        fail.append("nms")
    launches += DC.LAUNCHES

    path = str(ROOT / "exp" / "chip_smoke" / "served.pth")
    checkpoint.save_model(path, 0, model)
    DC.LAUNCHES = 0
    with cudnn_tf32(True):
        text, seconds = _cli_log(cli_test.main, data.args(
            1, "--batch_eval", "32", "--flip_test", "--device_warp",
            *bf16, "--load_model", path, "--exp_id",
            "chip_smoke_eval_bf16"))
    ap = _lines_with(text, "Mean AP")
    out["batch_eval_device_warp"] = {
        "seconds": seconds, "launches": DC.LAUNCHES,
        "stages": _lines_with(text, "stages (s)"),
        "mean_ap_line": ap[-1] if ap else None}
    if DC.LAUNCHES != 3 or not ap:
        fail.append("cli batch_eval")
    launches += DC.LAUNCHES
    out["failed"] = fail
    emit(out)
    if fail:
        raise SystemExit("bf16 check failed: {}".format(fail))
    return launches, timings


def with_tf32(trainer):
    """`trainer`'s step under cudnn_tf32(True), for timed_steps_in_turns."""
    def step(batch):
        with cudnn_tf32(True):
            return trainer.train_step(batch)
    return types.SimpleNamespace(train_step=step)


def phase_bf16_train(data, batches):
    """Training with bf16 conv operands: one FP32-recipe step card vs CPU
    at batch 4 from conditioned_init (loss BF16_LOSS_TOL, gradients
    BF16_GRAD_TOL); 8 steps at batch 32, bf16 and f32 in turns, with the
    backward launches by dtype; 3 QAT steps in bf16 and 3 in f32 from
    the train phase's FP32 checkpoint, in turns: losses within
    QAT_BF16_LOSS_TOL, every EMA range within QAT_BF16_RANGE_TOL.
    Returns (forward, backward) launches and the timed steps."""
    from codenet_torch.engine import checkpoint
    from codenet_torch.engine.trainer import Trainer
    from codenet_torch.models.layers import QuantSpec
    from codenet_torch.ops import deform_cuda as DC
    fail = []
    opts = {"bf16": data.opt(TRAIN_BATCH, "--dtype", "bfloat16"),
            "f32": data.opt(TRAIN_BATCH)}
    parity, ok = step_parity(data, conditioned_init(opts["bf16"]),
                             bf16=True)
    out = {"phase": "bf16_train", "parity": {
        "batch": 4, **parity, "tol_loss": BF16_LOSS_TOL,
        "tol_grad_rel_l2": BF16_GRAD_TOL}}
    if not ok:
        fail.append("parity")

    def trainers(qspec=None, path=None):
        made = {}
        for name, opt in opts.items():
            tr = Trainer(opt, qspec=qspec, device="cuda")
            if path:
                with contextlib.redirect_stdout(io.StringIO()):
                    checkpoint.load_model(path, tr.model)
            tr.init()
            made[name] = tr
        return made

    dtypes = []
    steps = trainers()
    with recording(DC, "_launch_bwd",
                   lambda x, s, w, g: dtypes.append(str(x.dtype))):
        runs = timed_steps_in_turns({
            "bf16": (with_tf32(steps["bf16"]), batches[:8], None),
            "f32": (steps["f32"], batches[:8], None)})
    out["steps_in_turns"] = runs
    out["bwd_launch_dtypes"] = {d: dtypes.count(d) for d in set(dtypes)}
    for run in runs.values():
        if not np.all(np.isfinite(run["losses"])) or any(
                st != [3, 3] for st in run["launches_per_step"]):
            fail.append("steps")
    if out["bwd_launch_dtypes"].get("torch.bfloat16", 0) != 3 * 8:
        fail.append("bf16 backward launches")

    qat = trainers(QuantSpec(), str(ROOT / "exp" / "chip_smoke"
                                    / "fp32.pth"))
    qruns = timed_steps_in_turns({
        "bf16": (with_tf32(qat["bf16"]), batches[:3], None),
        "f32": (qat["f32"], batches[:3], None)})
    l16 = np.asarray(qruns["bf16"]["losses"])
    l32 = np.asarray(qruns["f32"]["losses"])
    ranges = {name: {k: v.cpu() for k, v in tr.model.state_dict().items()
                     if k.endswith(("x_min", "x_max"))}
              for name, tr in qat.items()}
    range_err = max(float(((ranges["bf16"][k] - ranges["f32"][k]).abs()
                           - QAT_BF16_RANGE_TOL
                           * ranges["f32"][k].abs()).max())
                    for k in ranges["f32"])
    out["qat"] = {"losses_bf16": l16.tolist(), "losses_f32": l32.tolist(),
                  "loss_rel": (np.abs(l16 - l32) / np.abs(l32)).tolist(),
                  "ranges": len(ranges["f32"]),
                  "range_excess_over_rtol": range_err,
                  "tol_loss": QAT_BF16_LOSS_TOL,
                  "tol_range": QAT_BF16_RANGE_TOL,
                  "ms_per_step": {k: r["ms_per_step"]
                                  for k, r in qruns.items()}}
    if not np.all(np.isfinite(l16)) \
            or np.any(np.abs(l16 - l32) > QAT_BF16_LOSS_TOL * np.abs(l32)) \
            or range_err > QAT_BF16_RANGE_TOL:
        fail.append("qat")
    out["failed"] = fail
    emit(out)
    if fail:
        raise SystemExit("bf16_train check failed: {}".format(fail))
    launches = [sum(r[k] for r in list(runs.values())
                    + list(qruns.values()))
                for k in ("launches_fwd", "launches_bwd")]
    return launches, runs


def phase_deform_backbone(data):
    """The deform backbone (create_model(..., deform_backbone=True)): a
    256^2 forward card vs CPU port in f32 (BACKBONE_HEAD_TOL, calibrated
    BN stats as build_served_model sets them), 16 forward launches (13
    backbone, 3 deconv); one FP32 train step card vs CPU from
    conditioned_init, f32 (STEP_TOL) and with bf16 conv operands
    (BF16_LOSS_TOL, BF16_GRAD_TOL); int8 refused. Returns (forward,
    backward) launches."""
    from codenet_torch.models import create_model
    from codenet_torch.models.layers import QuantSpec
    from codenet_torch.ops import deform_cuda as DC
    fail = []
    model = build_served_model(deform_backbone=True)
    DC.LAUNCHES = DC.BWD_LAUNCHES = 0
    with torch.no_grad():
        fwd, ok = heads_card_vs_cpu(model, BACKBONE_HEAD_TOL, 16)
    launches = [DC.LAUNCHES, 0]
    out = {"phase": "deform_backbone", "forward": fwd}
    if not ok:
        fail.append("forward")
    opt = data.opt(TRAIN_BATCH)
    for name, bf16 in (("step_f32", False), ("step_bf16", True)):
        parity, ok = step_parity(data, conditioned_init(opt, True),
                                 deform_backbone=True, bf16=bf16)
        out[name] = {"batch": 4, **parity}
        launches = [a + b for a, b in zip(launches,
                                          parity["launches_fwd_bwd"])]
        if not ok:
            fail.append(name)
    try:
        create_model(opt.arch, opt.heads, opt.head_conv,
                     qspec=QuantSpec(int8_infer=True), deform_backbone=True,
                     device="cuda")
        fail.append("int8 not refused")
    except NotImplementedError as e:
        out["int8_refused"] = str(e)
    out["failed"] = fail
    emit(out)
    if fail:
        raise SystemExit("deform_backbone check failed: {}".format(fail))
    return launches


def _ms(ret):
    return {k: ret[k] * 1e3 for k in ("tot", "pre", "net", "dec", "post",
                                      "merge")}


def _stats_lines(text):
    """The COCO evaluator's printed summary lines (' AP = 0.000', ...)."""
    return [ln.strip() for ln in text.splitlines()
            if ln.startswith(" ") and " = " in ln]


def phase_coco_ctdet(data):
    """ctdet on COCO at COCO_RES^2 (80 classes): a batch-2 forward card vs
    CPU (1e-3 of each head's max, 3 launches); 8 flip-test requests
    through CtdetDetector with their stage timers and 4 batch-32 requests
    (64 forwards with the flipped copies); `cli.test --flip_test` over
    the 8 val frames, per image and with --batch_eval 32, each scored by
    the port's COCO evaluator (bbox, 12 stats). Returns the forward
    launches of the served paths."""
    from codenet_torch.cli import test as cli_test
    from codenet_torch.engine import checkpoint
    from codenet_torch.engine.detector import CtdetDetector
    from codenet_torch.ops import deform_cuda as DC
    fail = []
    model = build_served_model(heads=COCO_HEADS, res=COCO_RES)
    fwd, ok = heads_card_vs_cpu(model, 1e-3, 3, res=COCO_RES)
    out = {"phase": "coco_ctdet", "res": COCO_RES,
           "heads_card_vs_cpu": fwd}
    if not ok:
        fail.append("heads")
    opt = data.opt(1, "--flip_test")
    det = CtdetDetector(opt, state_dict=model.state_dict(), device="cuda")
    train, val = data.dataset(opt), data.dataset(opt, "val")
    DC.LAUNCHES = 0  # counts from here on are the served paths' own
    requests = []
    for i in range(len(val)):
        ret = det.run(val.load_image(i))
        requests.append(dict(_ms(ret), dets=int(sum(
            len(v) for v in ret["results"].values()))))
    pre = [det.pre_process(train.load_image(i), 1) for i in range(32)]
    stack = np.concatenate([p[0][0:1] for p in pre]
                           + [p[0][1:2] for p in pre], axis=0)
    tis = np.stack([p[1]["trans_inv"] for p in pre])
    batch_ms = []
    for _ in range(4):
        det._sync()
        t0 = time.perf_counter()
        dets = det.process_batch(stack, tis).cpu().numpy()
        batch_ms.append((time.perf_counter() - t0) * 1e3)
    launches = DC.LAUNCHES
    out.update(requests_ms=requests, batch=32, batch_ms=batch_ms,
               batch_img_per_s=32 / min(batch_ms[1:]) * 1e3,
               launches=launches)
    if launches != 3 * (len(val) + 4) or not np.isfinite(dets).all() \
            or dets.shape != (32, opt.K, 6):
        fail.append("served")

    path = str(ROOT / "exp" / "chip_smoke" / "coco_served.pth")
    checkpoint.save_model(path, 0, model)
    out["cli"] = {}
    for name, extra in (("per_image", []), ("batch_eval", ["--batch_eval",
                                                            "32"])):
        DC.LAUNCHES = 0
        text, seconds = _cli_log(cli_test.main, data.args(
            1, "--flip_test", "--load_model", path, "--exp_id",
            "chip_smoke_coco_" + name, *extra))
        stats = _stats_lines(text)
        out["cli"][name] = {"seconds": seconds, "launches": DC.LAUNCHES,
                            "stats": stats,
                            "stages": _lines_with(text, "stages (s)")}
        launches += DC.LAUNCHES
        want = 3 * len(val) if name == "per_image" else 3
        if DC.LAUNCHES != want or len(stats) != 12:
            fail.append("cli " + name)
    out["failed"] = fail
    emit(out)
    if fail:
        raise SystemExit("coco_ctdet check failed: {}".format(fail))
    return launches


def phase_multi_pose(data):
    """multi_pose (COCO keypoints) at COCO_RES^2, six heads: a batch-2
    forward card vs CPU (1e-3 of each head's max, 3 launches) and
    multi_pose_decode card vs CPU on the same flip-test heads
    (DECODE_TOL); 8 flip-test requests with their stage timers and one
    request at the five test scales with --nms (soft_nms_39); one FP32
    train step card vs CPU at batch 4 from conditioned_init (STEP_TOL);
    6 timed steps at batch 32 on sampler batches (the loader timed
    apart); then `cli.main multi_pose` -> `cli.quant_main` -> `cli.test
    --resume-quantize --flip_test`, scored by the port's keypoint COCO
    evaluator (10 stats). Returns (forward, backward) launches of the
    served, training and CLI paths."""
    from codenet_torch.cli import main as cli_main
    from codenet_torch.cli import quant_main
    from codenet_torch.cli import test as cli_test
    from codenet_torch.engine.detector import MultiPoseDetector
    from codenet_torch.models.decode import multi_pose_decode
    from codenet_torch.ops import deform_cuda as DC
    fail = []
    model = build_served_model(heads=POSE_HEADS, res=COCO_RES)
    fwd, ok = heads_card_vs_cpu(model, 1e-3, 3, res=COCO_RES)
    out = {"phase": "multi_pose", "res": COCO_RES,
           "heads_card_vs_cpu": fwd}
    if not ok:
        fail.append("heads")
    sd = model.state_dict()
    opt = data.opt(1, "--flip_test")
    det = MultiPoseDetector(opt, state_dict=sd, device="cuda")
    val = data.dataset(opt, "val")
    frames = [val.load_image(i) for i in range(len(val))]

    # the decode on one request's heads, card vs CPU (rows of score 0 are
    # tied peaks whose order is the top-k's own: held by count)
    images, _ = det.pre_process(frames[0], 1)
    with torch.inference_mode():
        heads = det._heads(det._to_device(images))
        card = multi_pose_decode(*heads, k=opt.K).cpu()
        cpu = multi_pose_decode(*(h.cpu() if h is not None else None
                                  for h in heads), k=opt.K)
    live = cpu[0, :, 4] > 0
    err = float((card[0][live] - cpu[0][live]).abs().max())
    out["decode_card_vs_cpu"] = {
        "max_abs_err": err, "tol": DECODE_TOL, "rows": int(live.sum()),
        "rows_card": int((card[0, :, 4] > 0).sum()),
        "finite": bool(torch.isfinite(card).all())}
    if not err <= DECODE_TOL or int((card[0, :, 4] > 0).sum()) \
            != int(live.sum()) or not out["decode_card_vs_cpu"]["finite"]:
        fail.append("decode")

    DC.LAUNCHES = DC.BWD_LAUNCHES = 0
    requests = []
    for f in frames:
        ret = det.run(f)
        requests.append(dict(_ms(ret), dets=len(ret["results"][1])))
    nms = MultiPoseDetector(data.opt(1, "--flip_test", "--test_scales",
                                     TEST_SCALES, "--nms"),
                            state_dict=sd, device="cuda")
    ret = nms.run(frames[0])
    rows = np.asarray(ret["results"][1], np.float32)
    served = DC.LAUNCHES
    scales = len(TEST_SCALES.split(","))
    out.update(requests_ms=requests, nms_request_ms=_ms(ret),
               nms_rows=len(rows), served_launches=served)
    if served != 3 * (len(frames) + scales) or not np.isfinite(rows).all() \
            or rows.shape != (scales * opt.K, 39):
        fail.append("served")

    run = _train_and_time(data, data.opt(TRAIN_BATCH), 6, fail, out,
                          parity_batch=4)
    launches = [served + run["launches_fwd"], run["launches_bwd"]]

    common = ["--num_epochs", "1", "--num_iters", "2", "--val_intervals",
              "-1", "--print_iter", "1"]

    def ckpt(exp_id):
        return str(ROOT / "exp" / "multi_pose" / exp_id / "model_last.pth")
    cli = _cli_runs(data, [
        ("main", cli_main.main, TRAIN_BATCH,
         common + ["--exp_id", "chip_smoke_pose"], 6, 6),
        ("quant_main", quant_main.main, TRAIN_BATCH,
         common + ["--exp_id", "chip_smoke_pose_qat", "--load_model",
                   ckpt("chip_smoke_pose")], 6, 6),
        ("test_fake_quant", cli_test.main, 1,
         ["--flip_test", "--resume-quantize", "--load_model",
          ckpt("chip_smoke_pose_qat"), "--exp_id", "chip_smoke_pose_fq"],
         3 * len(frames), 0)], _stats_lines, 10, out, fail)
    launches = [a + b for a, b in zip(launches, cli)]
    out["failed"] = fail
    emit(out)
    if fail:
        raise SystemExit("multi_pose check failed: {}".format(fail))
    return launches


def kitti_kernel_table(rows, bwd_rows):
    """Per KITTI map: the forward at batch 1 and 16 and the backward at
    16 (f32 and bf16) from the kernel phases, each with its time, bound,
    time over bound and plan."""
    table = {}
    for shape in KITTI_SHAPES:
        entry = {}
        for r in rows + bwd_rows:
            if tuple(r["shape"]) != shape:
                continue
            kind = "bwd" if r["phase"] == "kernel_bwd" else "fwd"
            plan = {k: r[k] for k in ("rows", "cb", "blocks") if k in r}
            entry["{}_{}_{}".format(kind, r["n"], r["dtype"])] = {
                "us": r["ms"] * 1e3, "bound_us": r["bound_us"],
                "x_bound": r["ms"] * 1e3 / r["bound_us"], **plan}
        table["x".join(map(str, shape))] = entry
    return table


def _cli_runs(data, runs, stats_of, want_stats, out, fail):
    """Each (name, entry point, batch, args, forward launches, backward
    launches) run with its output captured into out["cli"][name]:
    seconds, losses, the stats lines `stats_of` finds and launches. A run
    fails its check unless it launched as said, printed finite losses (2
    when it trains, none when it evaluates) and no final eval, and an
    eval printed `want_stats` stats lines. Returns the launches summed
    (forward, backward)."""
    from codenet_torch.cli import test as cli_test
    from codenet_torch.ops import deform_cuda as DC
    out["cli"], launches = {}, [0, 0]
    for name, fn, batch, args, want_fwd, want_bwd in runs:
        DC.LAUNCHES = DC.BWD_LAUNCHES = 0
        text, seconds = _cli_log(fn, data.args(batch, *args))
        losses = [float(ln.split(" loss ")[1].split()[0])
                  for ln in _lines_with(text, "train epoch")]
        stats = stats_of(text)
        out["cli"][name] = {"seconds": seconds, "losses": losses,
                            "stats": stats, "launches_fwd": DC.LAUNCHES,
                            "launches_bwd": DC.BWD_LAUNCHES}
        launches[0] += DC.LAUNCHES
        launches[1] += DC.BWD_LAUNCHES
        trains = fn is not cli_test.main
        # training runs no final eval but for ctdet (as in the JAX
        # package); an eval prints its evaluator's stats
        if (len(losses) != (2 if trains else 0)
                or not np.all(np.isfinite(losses))
                or len(stats) != (0 if trains else want_stats)
                or "Running final eval" in text
                or (DC.LAUNCHES, DC.BWD_LAUNCHES) != (want_fwd, want_bwd)):
            fail.append("cli " + name)
    return launches


def _train_and_time(data, topt, steps, fail, out,
                    parity_batch=TASK_STEP_BATCH):
    """One step card vs CPU at `parity_batch` from conditioned_init
    (STEP_TOL), then `steps` timed steps at topt's batch on sampler
    batches, the loader timed apart. Returns the timed run."""
    from codenet_torch.data.loader import DataLoader
    from codenet_torch.engine.trainer import Trainer
    parity, ok = step_parity(data, conditioned_init(topt),
                             batch=parity_batch)
    out["train_parity"] = {"batch": parity_batch, **parity,
                           "tol": STEP_TOL}
    if not ok:
        fail.append("train parity")
    loader = DataLoader(data.dataset(topt), topt.batch_size, shuffle=True,
                        num_workers=topt.num_workers, seed=topt.seed)
    t0 = time.perf_counter()
    batches = []
    while len(batches) < steps:
        batches.extend(loader)
    out["loader_ms_per_batch"] = (time.perf_counter() - t0) * 1e3 \
        / len(batches)
    out["loader_workers"] = topt.num_workers
    trainer = Trainer(topt, device="cuda")
    trainer.init()
    run = timed_steps(trainer, batches[:steps])
    del batches
    out["train"] = run
    if not np.all(np.isfinite(run["losses"])) or any(
            st != [3, 3] for st in run["launches_per_step"]):
        fail.append("train")
    return run


def phase_ddd(data, rows, bwd_rows):
    """ddd (KITTI 3D) at KITTI_HW, 3 classes, six heads: the kernel rows
    at KITTI's maps gathered (time, bound, plan); a batch-2 forward card
    vs CPU (TASK_HEAD_TOL, 3 launches) and ddd_decode card vs CPU on one
    request's heads (the rows of score > 0, DECODE_TOL); 8 requests, each
    with its own calib, with their stage timers; one FP32 step card vs
    CPU at TASK_STEP_BATCH and 6 timed steps at KITTI_TRAIN_BATCH; then
    `cli.main ddd` -> `cli.quant_main ddd` -> `cli.test ddd
    --resume-quantize`, prefetched and --not_prefetch_test, each printing
    the KITTI AP table (the two equal). Returns (forward, backward)
    launches of the served, training and CLI paths."""
    from codenet_torch.cli import main as cli_main
    from codenet_torch.cli import quant_main
    from codenet_torch.cli import test as cli_test
    from codenet_torch.engine.detector import DddDetector, eval_input
    from codenet_torch.models.decode import ddd_decode
    from codenet_torch.ops import deform_cuda as DC
    fail = []
    out = {"phase": "ddd", "input_hw": list(KITTI_HW),
           "kernels_at_kitti_maps": kitti_kernel_table(rows, bwd_rows)}
    model = build_served_model(heads=DDD_HEADS, res=KITTI_HW)
    fwd, ok = heads_card_vs_cpu(model, TASK_HEAD_TOL, 3, res=KITTI_HW)
    out["heads_card_vs_cpu"] = fwd
    if not ok:
        fail.append("heads")
    sd = model.state_dict()
    opt = data.opt(1)
    det = DddDetector(opt, state_dict=sd, device="cuda")
    val = data.dataset(opt, "val")
    frames = [val.load_image(i) for i in range(len(val))]
    calibs = [np.array(info["calib"], np.float32) for info in
              val.coco.loadImgs(ids=list(val.images))]

    images, _ = det.pre_process(frames[0], 1, {"calib": calibs[0]})
    with torch.inference_mode():
        o = det.model(eval_input(det._to_device(images), det.mean,
                                 det.std))
        heads = [o["hm"].sigmoid(), o["rot"],
                 1.0 / (o["dep"].sigmoid() + 1e-6) - 1.0, o["dim"],
                 o["wh"], o["reg"]]
        card = ddd_decode(*heads[:4], wh=heads[4], reg=heads[5],
                          k=opt.K).cpu()
        cpu = ddd_decode(*(h.cpu() for h in heads[:4]), wh=heads[4].cpu(),
                         reg=heads[5].cpu(), k=opt.K)
    live = cpu[0, :, 2] > 0
    err = float((card[0][live] - cpu[0][live]).abs().max())
    out["decode_card_vs_cpu"] = {
        "max_abs_err": err, "tol": DECODE_TOL, "rows": int(live.sum()),
        "rows_card": int((card[0, :, 2] > 0).sum()),
        "finite": bool(torch.isfinite(card).all())}
    if not err <= DECODE_TOL or int((card[0, :, 2] > 0).sum()) \
            != int(live.sum()) or not out["decode_card_vs_cpu"]["finite"]:
        fail.append("decode")

    DC.LAUNCHES = DC.BWD_LAUNCHES = 0  # counts from here on: main paths
    requests = []
    for frame, calib in zip(frames, calibs):
        ret = det.run(frame, {"calib": calib})
        requests.append(dict(_ms(ret), dets=int(sum(
            len(v) for v in ret["results"].values()))))
    served = DC.LAUNCHES
    out.update(requests_ms=requests, served_launches=served)
    if served != 3 * len(frames) \
            or not np.array_equal(det.this_calib, calibs[-1]):
        fail.append("served")

    run = _train_and_time(data, data.opt(KITTI_TRAIN_BATCH), 6, fail, out)
    launches = [served + run["launches_fwd"], run["launches_bwd"]]

    common = ["--num_epochs", "1", "--num_iters", "2", "--val_intervals",
              "-1", "--print_iter", "1"]

    def ckpt(exp_id):
        return str(ROOT / "exp" / "ddd" / exp_id / "model_last.pth")
    evals = ["--resume-quantize", "--load_model", ckpt("chip_smoke_ddd_qat")]
    cli = _cli_runs(data, [
        ("main", cli_main.main, KITTI_TRAIN_BATCH,
         common + ["--exp_id", "chip_smoke_ddd"], 6, 6),
        ("quant_main", quant_main.main, KITTI_TRAIN_BATCH,
         common + ["--exp_id", "chip_smoke_ddd_qat", "--load_model",
                   ckpt("chip_smoke_ddd")], 6, 6),
        ("test_fake_quant", cli_test.main, 1,
         evals + ["--exp_id", "chip_smoke_ddd_fq"], 3 * len(frames), 0),
        ("test_fake_quant_serial", cli_test.main, 1,
         evals + ["--not_prefetch_test", "--exp_id",
                  "chip_smoke_ddd_fq_serial"], 3 * len(frames), 0)],
        lambda text: _lines_with(text, ": AP2D "), 9, out, fail)
    launches = [a + b for a, b in zip(launches, cli)]
    # the KITTI AP table, prefetched and serial, the same
    if out["cli"]["test_fake_quant"]["stats"] \
            != out["cli"]["test_fake_quant_serial"]["stats"]:
        fail.append("cli prefetched vs serial")
    out["failed"] = fail
    emit(out)
    if fail:
        raise SystemExit("ddd check failed: {}".format(fail))
    return launches


def phase_exdet(data):
    """exdet (ExtremeNet) at COCO_RES^2, nine heads: a batch-2 forward card
    vs CPU (TASK_HEAD_TOL, 3 launches); exct_decode of one flip-test
    request's heads at the default K (100: 10^8 lattice cells an image)
    on the card, timed, with its peak device memory, and on the CPU: the
    kept scores within LATTICE_SCORE_TOL, the rows above the last kept
    score equal in count and within DECODE_TOL; 8 flip-test requests with their stage
    timers; one FP32 step card vs CPU at TASK_STEP_BATCH and 4 timed steps
    at batch 32; then `cli.main exdet` -> `cli.quant_main exdet` ->
    `cli.test exdet --flip_test --resume-quantize`, scored by the port's
    COCO evaluator (12 bbox stats). Returns (forward, backward) launches
    of the served, training and CLI paths."""
    from codenet_torch.cli import main as cli_main
    from codenet_torch.cli import quant_main
    from codenet_torch.cli import test as cli_test
    from codenet_torch.engine.detector import ExdetDetector, eval_input
    from codenet_torch.models.decode import exct_decode
    from codenet_torch.ops import deform_cuda as DC
    fail = []
    model = build_served_model(heads=EXDET_HEADS, res=COCO_RES)
    fwd, ok = heads_card_vs_cpu(model, TASK_HEAD_TOL, 3, res=COCO_RES)
    out = {"phase": "exdet", "res": COCO_RES, "heads_card_vs_cpu": fwd}
    if not ok:
        fail.append("heads")
    sd = model.state_dict()
    opt = data.opt(1, "--flip_test")
    det = ExdetDetector(opt, state_dict=sd, device="cuda")
    val = data.dataset(opt, "val")
    frames = [val.load_image(i) for i in range(len(val))]

    images, _ = det.pre_process(frames[0], 1)
    kw = dict(k=opt.K, scores_thresh=opt.scores_thresh,
              center_thresh=opt.center_thresh, aggr_weight=opt.aggr_weight,
              agnostic=opt.agnostic_ex)
    with torch.inference_mode():
        o = det.model(eval_input(det._to_device(images), det.mean,
                                 det.std))
        heads = [o["hm_" + p].sigmoid() for p in "tlbrc"] \
            + [o["reg_" + p] for p in "tlbr"]
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        card = exct_decode(*heads, **kw)
        torch.cuda.synchronize()
        card_ms = (time.perf_counter() - t0) * 1e3
        peak = torch.cuda.max_memory_allocated() - base
        card = card.cpu()
        t0 = time.perf_counter()
        cpu = exct_decode(*(h.cpu() for h in heads), **kw)
        cpu_ms = (time.perf_counter() - t0) * 1e3
    # the kept scores in order; the rows above the last kept score as a
    # set (lattice cells that tie at the cut may be kept either way)
    score_err = float((card[..., 4] - cpu[..., 4]).abs().max())
    row_err, rows, rows_card, positive = 0.0, 0, 0, 0
    for i in range(card.shape[0]):
        cut = float(cpu[i, -1, 4])
        a = card[i][card[i, :, 4] > cut].numpy()
        b = cpu[i][cpu[i, :, 4] > cut].numpy()
        rows, rows_card = rows + len(b), rows_card + len(a)
        positive += int((cpu[i, :, 4] > 0).sum())
        if len(a) == len(b) and len(b):
            a, b = a[np.lexsort(a.T[::-1])], b[np.lexsort(b.T[::-1])]
            row_err = max(row_err, float(np.abs(a - b).max()))
    out["decode_card_vs_cpu"] = {
        "k": opt.K, "lattice_cells_per_image": opt.K ** 4,
        "shape": list(card.shape), "score_max_abs_err": score_err,
        "score_tol": LATTICE_SCORE_TOL, "rows_above_cut": rows,
        "rows_above_cut_card": rows_card, "rows_score_gt_0": positive,
        "row_max_abs_err": row_err,
        "row_tol": DECODE_TOL, "card_ms": card_ms, "cpu_ms": cpu_ms,
        "card_peak_bytes_over_heads": peak,
        "card_max_memory_allocated": torch.cuda.max_memory_allocated(),
        "finite": bool(torch.isfinite(card).all())}
    if not score_err <= LATTICE_SCORE_TOL or rows != rows_card or not rows \
            or not row_err <= DECODE_TOL \
            or not out["decode_card_vs_cpu"]["finite"]:
        fail.append("decode")

    DC.LAUNCHES = DC.BWD_LAUNCHES = 0  # counts from here on: main paths
    requests = []
    for frame in frames:
        ret = det.run(frame)
        requests.append(dict(_ms(ret), dets=int(sum(
            len(v) for v in ret["results"].values()))))
    served = DC.LAUNCHES
    out.update(requests_ms=requests, served_launches=served)
    if served != 3 * len(frames):
        fail.append("served")

    run = _train_and_time(data, data.opt(TRAIN_BATCH), 4, fail, out)
    launches = [served + run["launches_fwd"], run["launches_bwd"]]

    common = ["--num_epochs", "1", "--num_iters", "2", "--val_intervals",
              "-1", "--print_iter", "1"]

    def ckpt(exp_id):
        return str(ROOT / "exp" / "exdet" / exp_id / "model_last.pth")
    cli = _cli_runs(data, [
        ("main", cli_main.main, TRAIN_BATCH,
         common + ["--exp_id", "chip_smoke_exdet"], 6, 6),
        ("quant_main", quant_main.main, TRAIN_BATCH,
         common + ["--exp_id", "chip_smoke_exdet_qat", "--load_model",
                   ckpt("chip_smoke_exdet")], 6, 6),
        ("test_fake_quant", cli_test.main, 1,
         ["--flip_test", "--resume-quantize", "--load_model",
          ckpt("chip_smoke_exdet_qat"), "--exp_id", "chip_smoke_exdet_fq"],
         3 * len(frames), 0)], _stats_lines, 12, out, fail)
    launches = [a + b for a, b in zip(launches, cli)]
    out["failed"] = fail
    emit(out)
    if fail:
        raise SystemExit("exdet check failed: {}".format(fail))
    return launches


def kernel_line_entry(name, source, replaces, launches, rows, shapes_of):
    """One entry of the kernels line: times summed over the three
    deconv-stage calls the path gives the kernel (`shapes_of` picks the
    rows)."""
    path = [r for r in rows if shapes_of(r)]
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches,
            "max_abs_err": max(max(r.get(k, 0.0) for k in
                                   ("max_abs_err", "dx", "ds", "dw"))
                               for r in rows),
            "ms": sum(r["ms"] for r in path),
            "plain_ms": sum(r["plain_ms"] for r in path),
            "bound_ms": sum(r["bound_us"] for r in path) / 1e3,
            "bound_by": "bytes" if all(r["bound_by"] == "bytes"
                                       for r in path) else "operations",
            "library_ms": None}


def path_ms(rows, name, n, dtype, backbone_calls=None, shapes=MODEL_SHAPES):
    """{"ms_<name>", "bound_ms_<name>", "launches_<name>"} of one pass of
    a path over the kernel rows at batch n and `dtype`: the three deconv
    calls at `shapes` (256^2 by default), and with `backbone_calls`
    ({shape: calls}) the deform backbone's too."""
    calls = {tuple(shape): 1 for shape in shapes}
    calls.update(backbone_calls or {})
    picked = [(r, calls[tuple(r["shape"])]) for r in rows
              if tuple(r["shape"]) in calls and r["n"] == n
              and r["dtype"] == dtype]
    return {"ms_" + name: sum(r["ms"] * k for r, k in picked),
            "bound_ms_" + name: sum(r["bound_us"] * k
                                    for r, k in picked) / 1e3,
            "launches_" + name: sum(k for _, k in picked)}


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--out", default="",
                        help="also write every printed line to this file")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        sys.exit("chip_smoke.py needs a CUDA card; none is visible")
    sys.path.insert(0, str(ROOT))
    import codenet_torch  # noqa: F401  (fails outside a checkout)

    t0 = time.perf_counter()
    smi = phase_env()
    bw, flops = card_peaks(torch.cuda.get_device_name(0))
    phase_build()
    rows = phase_kernels(bw, flops)
    bwd_rows = phase_kernel_bwd(bw, flops)
    keep_res_rows, keep_res_requests = phase_kernel_keep_res(bw, flops)
    model = build_served_model()
    phase_model(model)
    serve_launches = phase_detector(model)
    data = SmokeData()
    fp32, batches, train_run = phase_train(data)
    qat_run, qat_eval_launches, qat_model = phase_qat(data, fp32, batches)
    cli_bf16 = phase_cli(data)
    int8_launches, int8_cli_launches, int8_bf16 = phase_int8(
        data, qat_model, bw, flops)
    cache_fwd, cache_bwd = phase_devcache(data, train_run, batches)
    eval_paths_launches = phase_eval_paths(data, model)
    multiscale_launches = phase_multiscale(model, synthetic_frames(8)[0])
    bf16_launches, _ = phase_bf16(model, data)
    bf16_train, _ = phase_bf16_train(data, batches)
    backbone = phase_deform_backbone(data)
    coco_launches = phase_coco_ctdet(CocoSmokeData("ctdet"))
    pose = phase_multi_pose(CocoSmokeData("multi_pose"))
    ddd = phase_ddd(KittiSmokeData(), rows, bwd_rows)
    exdet = phase_exdet(CocoSmokeData("exdet"))

    pallas = next(ROOT.glob("*/ops/deform_pallas.py"))
    lines = pallas.read_text().splitlines()

    def replaces(fn):
        line = next(i + 1 for i, ln in enumerate(lines)
                    if ln.startswith("def {}(".format(fn)))
        return "{}:{}".format(pallas.relative_to(ROOT), line)

    emit({"phase": "done", "seconds": time.perf_counter() - t0,
          "card": smi})
    emit(smi)
    fwd_entry = kernel_line_entry(
        "codesign_deform_fwd", "codenet_torch/csrc/deform_fwd.cu",
        replaces("_fwd_kernel"),
        serve_launches + train_run["launches_fwd"]
        + qat_run["launches_fwd"] + qat_eval_launches + int8_launches
        + int8_cli_launches + cache_fwd + eval_paths_launches
        + multiscale_launches + bf16_launches + bf16_train[0]
        + backbone[0] + cli_bf16[0] + coco_launches + pose[0] + ddd[0]
        + exdet[0],
        rows + keep_res_rows,
        lambda r: r["model_shape"] and r["n"] == 2
        and r["dtype"] == "float32")
    # and the three calls of each --keep_res request of the kernel cases
    fwd_entry["keep_res_requests"] = keep_res_requests
    # and the three calls of one train forward (batch 32, f32), and of one
    # int8 served forward (batch 2, bf16, the weight cast included)
    fwd_entry["ms_train_forward"] = sum(
        r["ms"] for r in rows if r["model_shape"]
        and r["n"] == TRAIN_BATCH and r["dtype"] == "float32")
    fwd_entry["ms_int8_forward_bf16"] = int8_bf16["ms_int8_forward_bf16"]
    fwd_entry["bound_ms_int8_forward_bf16"] = \
        int8_bf16["bound_ms_int8_forward_bf16"]
    # and of one served forward with bf16 operands (batch 2)
    fwd_entry.update(path_ms(rows, "served_forward_bf16", 2, "bfloat16"))
    # and of one served forward at 512^2 (the COCO family; batch 2, f32)
    fwd_entry.update(path_ms(rows, "served_forward_512", 2, "float32",
                             shapes=COCO_SHAPES))
    # and of one served ddd forward at 384x1280 (batch 1: no flip test)
    fwd_entry.update(path_ms(rows, "served_forward_kitti", 1, "float32",
                             shapes=KITTI_SHAPES))
    # backward: one train step's three calls (batch 32, f32); launches
    # over the FP32, QAT, image-cache, bf16, deform-backbone, multi_pose,
    # ddd and exdet training paths and the CLIs that train
    bwd_entry = kernel_line_entry(
        "codesign_deform_bwd", "codenet_torch/csrc/deform_bwd.cu",
        replaces("_bwd_kernel"),
        train_run["launches_bwd"] + qat_run["launches_bwd"] + cache_bwd
        + bf16_train[1] + backbone[1] + cli_bf16[1] + pose[1] + ddd[1]
        + exdet[1], bwd_rows,
        lambda r: r["model_shape"] and r["n"] == TRAIN_BATCH
        and r["dtype"] == "float32")
    # and of one bf16 train step (3 calls), and of one deform-backbone
    # train step (16 calls: 13 backbone, 3 deconv; batch 32, f32)
    bwd_entry.update(path_ms(bwd_rows, "train_step_bf16", TRAIN_BATCH,
                             "bfloat16"))
    bwd_entry.update(path_ms(bwd_rows, "train_step_deform_backbone",
                             TRAIN_BATCH, "float32", BACKBONE_CALLS))
    # and of one train step at 512^2 (multi_pose; batch 32, f32)
    bwd_entry.update(path_ms(bwd_rows, "train_step_512", TRAIN_BATCH,
                             "float32", shapes=COCO_SHAPES))
    # and of one ddd train step at 384x1280 (batch 16, f32)
    bwd_entry.update(path_ms(bwd_rows, "train_step_kitti", KITTI_TRAIN_BATCH,
                             "float32", shapes=KITTI_SHAPES))
    emit({"kernels": [
        # forward: one served forward (flip-test batch 2, f32); launches
        # over the serving, training, QAT, fake-quant eval, int8 eval,
        # image-cache training, batched eval, multi-scale, bf16,
        # deform-backbone, COCO, multi_pose, ddd and exdet paths and CLIs
        fwd_entry, bwd_entry]})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text("\n".join(_lines) + "\n")


if __name__ == "__main__":
    main()
