"""Smoke test of the PyTorch port on one CUDA card.

    python3 chip_smoke.py [--out FILE]

Builds the co-designed deform conv kernels (codenet_torch/csrc/
deform_fwd.cu and deform_bwd.cu, one nvcc each, in parallel, beside the
host KITTI scorer csrc/kitti_eval.cpp) and holds each kernel against its
plain PyTorch version at the shapes the model gives it (the forward at
batches 2, 32, 64 and 128, and at the non-square maps of --keep_res
requests; the deform backbone's 32x32x58, 16x16x116 and 8x8x232; the
512^2 maps 16x16x1024, 32x32x256 and 64x64x128; KITTI's 12x40x1024,
24x80x256 and 48x160x128; the 128^2 regression's 4x4x1024, 8x8x256 and
16x16x128; the 2x network's 16x16x2153 at batches 2, 32, 64 and 128) and
at ragged ones, timing both. It reports what the card's
host offers for image files (host_io: cv2, PIL, imageio, libjpeg,
libturbojpeg, libpng) and round-trips a frame through the port's PNG
writer and reader. Then it drives the port's paths at full width
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
- data parallelism (ddp, codenet_torch/parallel/): an NCCL group over
  every visible card trains config a at batch 32 with
  --device_cache_shard (timed FP32 and QAT steps with each rank's peak
  memory, then cli.main's and cli.quant_main's training as that rank);
  two gloo ranks sharing one card race the kernels' first build, then
  train 3 FP32 and 3 QAT steps from the conditioned init held to one
  process on the card (5e-3) with bit-equal rank states, and one
  --device_cache_shard step; each rank's kernel launches count in the
  kernels line;
- image rows split over ranks (spatial, --spatial_shard 2): gloo ranks
  sharing one card as dp 1 x sp 2 and dp 2 x sp 2 train 3 FP32 and 3
  QAT steps of config a at batch 32 from the conditioned init, held to
  one process on the card (5e-3) with bit-equal rank states, each
  rank's ms per step and peak memory beside one process's; the dp 1 x
  sp 2 ranks also take a --device_cache step and train through
  `cli.main --spatial_shard 2`; with two cards visible, the dp 1 x sp 2
  steps over NCCL across them;
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
  port's COCO evaluator;
- real int8 of every task (int8_tasks): COCO ctdet, multi_pose, ddd and
  exdet from their phases' QAT checkpoints, each exported to its W4A8
  artifact and served from the .pth and the artifact (equal detections
  and equal decoded top-K),
  int8 heads card vs CPU and against act-clamp fake-quant, `cli.test
  --int8_infer` with the task's evaluator;
- the paper's configs b-e (configs_ae; config a is the main path): each
  at its input side (256^2 with --maxpool; 512^2; 512^2 --w2; 512^2 --w2
  --maxpool) with the full-width 1x or 2x network, heads card vs CPU,
  FP32 and QAT (--wt-percentile --act_clamp) steps at batch 32 with peak
  memory, for config d one step card vs CPU (the 2153-channel backward),
  flip-test requests; then tools_torch/run_configs_ae.py --smoke over
  b-e on PNG files (FP32 -> QAT -> fake-quant and int8 evals -> export),
  and from each config's QAT checkpoint and artifact: equal detections,
  int8 heads card vs CPU and against act-clamp fake-quant, the int8 and
  fake-quant forwards timed, the artifact's bytes beside the reference's;
- the profiler trace (trace, utils/profile.py): `cli.main --trace` on
  config a (batch 32, 3 steps, its final eval) and `cli.test --trace
  --flip_test`, each trace file's deform kernel events held equal to the
  launch counters, its 10 device ops with the most time, its kernel
  count and the device's busy share; profile_model's MACs and
  parameters of configs a-e, equal on the CPU and on the card;
- the dense targets (dense_targets): config a with --mse_loss
  --dense_wh, a step card vs CPU from host batches and from
  --device_cache, and timed steps from each in turns; multi_pose at
  512^2 with --mse_loss --dense_hp; ddd and exdet with --mse_loss;
- the deform-conv ladder and the op inventory (ladder_ops): every rung,
  InPlace-ABN, ROI-Align and PS-ROI pooling, forward and backward, card
  vs CPU;
- the JAX package's default engine (graphs): config a at batch 32 from
  conditioned_init, an epoch through Trainer.run_epoch's chunked engine
  (each step a replay of one CUDA graph of the train step) against one
  through its per-step path, in FP32, QAT and --device_cache (weights
  and loss meters within 5e-3, steps timed in turns, the replayed
  launches against a profiler trace); the fused heads against the
  per-head ones (eval and a train step, 1e-5); K-batch cached eval as
  one graph against the per-batch loop; the 5-scale merge with the
  native soft-NMS (csrc/nms.cpp) beside the numpy one;
- the synthetic accuracy regression (synthreg,
  tools_torch/synthetic_regression.py at its --smoke size): FP32, QAT
  and clamp-trained QAT through the CLIs on PNG files it writes, eight
  held-out APs, the fp32 and clamped fake-quant APs over a floor and
  the delta bands that hold at any training length, and its 128^2
  train steps timed.

Every phase prints one JSON line; a phase that fails ends the script with
a non-zero exit. The last three lines are the card (nvidia-smi), the kernel
table ({"kernels": [...]}) and {"ok": true, "device": {...}}; the line
before them gives each phase's wall seconds. `--phases trace,...` runs
only the named phases that need no other's results (trace,
dense_targets, ladder_ops, graphs, ddp, spatial), after the build (no
kernel table, no ok line).

Weights are random (seeded): for serving, BN running stats are set from a
random batch and the deform scale predictors are redrawn, so that s is
fractional and partly outside the maps; training starts from the port's
init (s == 1), its card-vs-CPU parity steps (FP32 and QAT) from that init
with the BN biases raised (conditioned_init). The training and task
phases' images are synthetic frames held in memory (the dataset's
`load_image` is overridden); the regression's are PNG files on disk.
TF32 is off throughout: the parity phases compare FP32 against FP32.
"""

from __future__ import annotations

import argparse
import contextlib
import copy
import dataclasses
import io
import itertools
import json
import os
import shutil
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
# the synthetic accuracy regression (tools_torch/synthetic_regression.py)
# at 128^2: its three deconv-stage maps (on the 4x4 map most samples at
# s up to 8 fall off the image) at its train batch (16) and the
# flip-test eval's (2)
SYNTH_SHAPES = [(4, 4, 1024), (8, 8, 256), (16, 16, 128)]
SYNTH_TRAIN_BATCH = 16
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
TRAIN_TIMED_STEPS = 8  # config a FP32 steps (train), and cache vs host
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
# CenterNet's other backbones on COCO ctdet at 512^2, each with its
# per-card train batch: experiments/ctdet_coco_{resdcn18,dla_34,hg}.sh
# split over their GPUs (res_18 as resdcn_18, dlav0_34 as dla_34)
ARCHS = [("res_18", 32), ("resdcn_18", 32), ("dlav0_34", 16),
         ("dla_34", 16), ("hourglass", 5)]
# f32 heads card vs CPU (every stack's), each within this of its max
ARCH_HEAD_TOL = 2e-3
ARCH_TIMED_STEPS = 3
# the BN whose ReLU feeds each arch's heads (they have no BN of their
# own): conditioned_init leaves its bias at 0, so the heatmap logits stay
# off the loss's clamp, and raises the others' by ARCH_BN_SHIFT. Raised
# by 3 (BN_SHIFT), resdcn_18's step on an H100 was 5.2e-3 from the CPU's
# (median tensor, 512^2), and tools_torch/step_conditioning.py --arch
# resdcn_18 --batch 2 puts f32 6.6e-4 from f64 at 256^2; raised by 6,
# 3.3e-6 at 256^2 and 2.1e-4 at 512^2 (hourglass 2.9e-4)
ARCH_BN_SHIFT = 6.0
HEAD_FEATURE_BNS = {"res_18": ("deconv_layers.7",),
                    "resdcn_18": ("deconv_layers.16",),
                    "dlav0_34": ("dla_up.ida_2.node_3.1",),
                    "dla_34": ("ida_up.node_2.actf.0",),
                    "hourglass": ("cnvs.0.bn", "cnvs.1.bn")}
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
                             4)
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
           "kitti_shape": shape in KITTI_SHAPES,
           "synth_shape": shape in SYNTH_SHAPES,
           "w2_shape": shape == W2_SHAPE}
    emit(row)
    if launched != 1 or not err <= TOL[dtype]:
        raise SystemExit("{} check failed: {}".format(phase, row))
    return row


def phase_kernels(bw, flops):
    """Forward kernel vs its plain version on the card at every shape,
    batch, dtype; each row with its launch plan (deform_cuda.fwd_plan).
    The deform backbone's, the 512^2, KITTI's and the 128^2 regression's
    maps at the served and trained batches; the 2x network's 16x16x2153
    at 2, 32, 64 and 128."""
    gen = torch.Generator().manual_seed(SEED)
    cases = [(shape, n) for shape in BWD_SHAPES
             for n in (BATCHES if shape in MODEL_SHAPES
                       else RAGGED_BATCHES)]
    cases += [(shape, n) for shape in BACKBONE_SHAPES + COCO_SHAPES
              for n in (2, TRAIN_BATCH)]
    cases += [(shape, n) for shape in KITTI_SHAPES
              for n in (1, KITTI_TRAIN_BATCH)]
    cases += [(shape, n) for shape in SYNTH_SHAPES
              for n in (2, SYNTH_TRAIN_BATCH)]
    # the 2x network's deconv0 map (configs d and e) at the train forward
    # and a batch-32 request with its flipped copies
    cases += [(W2_SHAPE, n) for n in (TRAIN_BATCH, 64)]
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
    (the deform backbone's, the 512^2, KITTI's and the 128^2
    regression's maps at the trained batch): error
    of dx, ds and dw relative to each output's max; each row with its
    launch plan (deform_cuda.bwd_plan)."""
    from codenet_torch.ops import deform_cuda as DC
    gen = torch.Generator().manual_seed(SEED + 2)
    rows = []
    cases = [(shape, n) for shape in BWD_SHAPES for n in BWD_BATCHES]
    cases += [(shape, TRAIN_BATCH) for shape in BACKBONE_SHAPES
              + COCO_SHAPES]
    cases += [(shape, KITTI_TRAIN_BATCH) for shape in KITTI_SHAPES]
    cases += [(shape, SYNTH_TRAIN_BATCH) for shape in SYNTH_SHAPES]
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
                2)
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
                   "kitti_shape": shape in KITTI_SHAPES,
                   "synth_shape": shape in SYNTH_SHAPES,
                   "w2_shape": shape == W2_SHAPE}
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
                       heads=None, res=RES, w2=False, maxpool=False):
    """Full-width PoseShuffleNetV2 1x on `device` (2x with w2, the pooled
    stem with maxpool; with deform_backbone,
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
                         w2=w2, maxpool=maxpool,
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
    vs on the CPU (plain) from the same weights: per head (of every
    stack) the shape, max |difference| and its ratio to the head's max
    |value|, finiteness; ok when every head is
    finite and within `tol` and the card's forward launched the forward
    kernel `launches` times."""
    from codenet_torch.engine.trainer import stacks
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
    # hourglass: every stack's heads, named hm0, hm1, ...
    pairs = [(head + (str(i) if isinstance(ref, list) else ""), r,
              o_dict[head].cpu())
             for i, (r_dict, o_dict) in enumerate(zip(stacks(ref),
                                                      stacks(out)))
             for head, r in r_dict.items()]
    for name, r, o in pairs:
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
# BaseDataset.load_image as the port defines it (it reads the file)
FILE_LOAD_IMAGE = []


def serve_frames_from_memory():
    """Every dataset's `load_image` returns the in-memory frame of FRAMES:
    the sets of the training and task phases are written as annotations
    only."""
    from codenet_torch.data.datasets import BaseDataset
    if not FILE_LOAD_IMAGE:
        FILE_LOAD_IMAGE.append(BaseDataset.load_image)
    BaseDataset.load_image = \
        lambda ds, index: FRAMES[ds.img_dir, ds.images[index]]


@contextlib.contextmanager
def images_from_files():
    """Within the block every dataset reads its image files again."""
    from codenet_torch.data.datasets import BaseDataset
    override = BaseDataset.load_image
    if FILE_LOAD_IMAGE:
        BaseDataset.load_image = FILE_LOAD_IMAGE[0]
    try:
        yield
    finally:
        BaseDataset.load_image = override


class SmokeData:
    """A synthetic VOC set for the training phases: `n_train` + `n_val`
    frames (synthetic_frames) held in memory, their annotations written
    under exp/ (the layout data/datasets.py::PascalVOC reads), and every
    dataset's `load_image` overridden to return the in-memory frames."""
    task, name, res = "ctdet", "pascal", RES

    def __init__(self, n_train=64, n_val=8, write=True):
        """write=False: the frames alone (a process of the ddp phase, whose
        parent wrote the annotations)."""
        frames, gt = synthetic_frames(n_train + n_val)
        self.data_dir = ROOT / "exp" / "chip_smoke" / "data"
        ann_dir = self.data_dir / "voc" / "annotations"
        ann_dir.mkdir(parents=True, exist_ok=True)
        for name, ids in (("trainval0712", range(1, n_train + 1)),
                          ("test2007", range(n_train + 1,
                                             n_train + n_val + 1))):
            if not write:
                break
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

    def args(self, batch, *extra, arch="shufflenetv2"):
        """CLI arguments; arch None leaves --arch out (the CLIs' default,
        dla_34)."""
        return [self.task, "--dataset", self.name,
                *(["--arch", arch] if arch else []),
                "--input_res", str(self.res), "--batch_size", str(batch),
                "--num_workers", "8", "--data_dir", str(self.data_dir),
                *extra]

    def opt(self, batch, *extra, arch="shufflenetv2"):
        from codenet_torch import config as cfg
        return cfg.update_dataset_info_and_set_heads(
            cfg.parse(self.args(batch, *extra, arch=arch)),
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

    def args(self, batch, *extra, arch="shufflenetv2"):
        return [self.task, "--dataset", self.name, "--arch", arch,
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
    def grad(p):  # a parameter nothing reads (a DLA tree's projection
        # above its subtrees) has none: 0, as the JAX package's
        return (torch.zeros_like(p) if p.grad is None
                else p.grad).detach().double().cpu()
    ref = {n: grad(p) for n, p in ref_model.named_parameters()}
    gmax = max(float(g.abs().max()) for g in ref.values())
    for name, p in model.named_parameters():
        a = grad(p)
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
    bias raised by BN_SHIFT (ARCH_BN_SHIFT in the other archs) but those
    before the heads' last convs.

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
    the loss's sigmoid clamp; in the other archs, whose heads have no
    BN, the BN whose ReLU feeds the heads (HEAD_FEATURE_BNS)."""
    from codenet_torch.models import create_model
    model = create_model(opt.arch, opt.heads, opt.head_conv, device="cpu",
                         w2=opt.w2, maxpool=opt.maxpool,
                         deform_backbone=deform_backbone,
                         generator=torch.Generator().manual_seed(opt.seed))
    keep = {head + ".4" for head in opt.heads} \
        | set(HEAD_FEATURE_BNS.get(opt.arch, ()))
    shift = ARCH_BN_SHIFT if opt.arch in HEAD_FEATURE_BNS else BN_SHIFT
    with torch.no_grad():
        for name, m in model.named_modules():
            if isinstance(m, torch.nn.BatchNorm2d) and name not in keep:
                m.bias.add_(shift)
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
                bf16=False, batch=4, extra=()):
    """One train step at `batch` on the card and on the CPU from the same
    weights and batch: the loss, the gradients over all parameters, the
    median tensor and each deform-block tensor (grads_vs), each held at
    STEP_TOL (with bf16 conv operands: the loss at BF16_LOSS_TOL and all
    gradients together at BF16_GRAD_TOL); the step's kernel launches.
    `extra`: more command-line flags; with --device_cache the batch's
    rows come from an image cache on each device."""
    from codenet_torch.data.loader import DataLoader
    from codenet_torch.engine.trainer import batch_to_device
    from codenet_torch.ops import deform_cuda as DC
    opt = data.opt(batch, *(["--dtype", "bfloat16"] if bf16 else []),
                   *extra)
    ds = data.dataset(opt)
    stacks = {}
    if opt.device_cache:
        from codenet_torch.data.device_cache import ImageCache
        cache = ImageCache.build(ds)
        ds._image_cache_dims = cache.dims
        stacks["cpu"] = torch.from_numpy(cache.images.copy())
        stacks["cuda"] = cache.to_device("cuda")
    batch = next(iter(DataLoader(ds, batch, shuffle=True, num_workers=4,
                                 seed=1)))

    def on(dev):
        b = batch_to_device(batch, dev)
        if dev in stacks:
            b["cache_images"] = stacks[dev]
        return b
    card, cpu = (make_trainer(opt, dev, qspec, deform_backbone)
                 for dev in ("cuda", "cpu"))
    card.model.load_state_dict(state_dict)
    cpu.model.load_state_dict(state_dict)
    card.init()
    cpu.init()
    DC.LAUNCHES = DC.BWD_LAUNCHES = 0
    with cudnn_tf32(bf16):
        got = card.train_step(on("cuda"))
        torch.cuda.synchronize()
    launches = (DC.LAUNCHES, DC.BWD_LAUNCHES)
    ref = cpu.train_step(on("cpu"))
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


def timed_steps_with_memory(trainer, batches):
    """timed_steps with the peak memory allocated over them, in MiB
    (`peak_mib`)."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    run = timed_steps(trainer, batches)
    run["peak_mib"] = torch.cuda.max_memory_allocated() / 2 ** 20
    return run


def loader_batches(dataset, batch_size, n, num_workers, seed):
    """The first n batches of a shuffled loader over `dataset`, taking
    more epochs where one holds fewer, and the loader's ms per batch."""
    from codenet_torch.data.loader import DataLoader
    loader = DataLoader(dataset, batch_size, shuffle=True,
                        num_workers=num_workers, seed=seed)
    t0 = time.perf_counter()
    batches = []
    while len(batches) < n:
        batches.extend(loader)
    return batches[:n], (time.perf_counter() - t0) * 1e3 / len(batches)


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
        steady = float(np.median(run["ms"][1:] or run["ms"]))
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
    """FP32 training: one step card vs CPU at batch 4; then
    TRAIN_TIMED_STEPS steps at batch 32 on port-sampler batches, the
    loader timed separately."""
    from codenet_torch.engine.trainer import Trainer
    opt = data.opt(TRAIN_BATCH)
    parity, ok = step_parity(data, conditioned_init(opt))
    emit({"phase": "train_parity", "batch": 4, "bn_shift": BN_SHIFT,
          **parity, "tol": STEP_TOL})
    if not ok:
        raise SystemExit("train parity check failed")

    batches, loader_ms = loader_batches(data.dataset(opt), TRAIN_BATCH,
                                        TRAIN_TIMED_STEPS, opt.num_workers,
                                        opt.seed)
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

    The parity step does not start from the trained weights: the FP32
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
    beside the train phase's host loader; TRAIN_TIMED_STEPS FP32 steps at
    batch 32 from the cache in turns with as many on the train phase's
    host batches (two
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

    batches, out["loader_ms_per_batch"] = loader_batches(
        ds, TRAIN_BATCH, TRAIN_TIMED_STEPS, opt.num_workers, opt.seed)
    out["host_loader_ms_per_batch"] = train_run["loader_ms_per_batch"]
    trainer = Trainer(opt, device="cuda")
    trainer.init()
    host_trainer = Trainer(data.opt(TRAIN_BATCH), device="cuda")
    host_trainer.init()
    runs = timed_steps_in_turns({
        "cache": (trainer, batches, stack),
        "host": (host_trainer, host_batches, None)})
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
    BF16_GRAD_TOL); 6 steps at batch 32, bf16 and f32 in turns, with the
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
            "bf16": (with_tf32(steps["bf16"]), batches[:6], None),
            "f32": (steps["f32"], batches[:6], None)})
    out["steps_in_turns"] = runs
    out["bwd_launch_dtypes"] = {d: dtypes.count(d) for d in set(dtypes)}
    for run in runs.values():
        if not np.all(np.isfinite(run["losses"])) or any(
                st != [3, 3] for st in run["launches_per_step"]):
            fail.append("steps")
    if out["bwd_launch_dtypes"].get("torch.bfloat16", 0) != 3 * 6:
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
    the port's COCO evaluator (bbox, 12 stats); then `cli.main` ->
    `cli.quant_main` (2 steps each, each with its final eval), the QAT
    checkpoint of the int8_tasks phase. Returns the (forward, backward)
    launches of the served, CLI and training paths."""
    from codenet_torch.cli import main as cli_main
    from codenet_torch.cli import quant_main
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
    # the QAT checkpoint of the int8_tasks phase, as multi_pose's phase
    # writes its own: cli.main (2 steps at batch 32 from the port's init)
    # -> cli.quant_main (2 steps), each ending in its eval of 8 frames
    common = ["--num_epochs", "1", "--num_iters", "2", "--val_intervals",
              "-1", "--print_iter", "1"]
    fp32 = str(ROOT / "exp" / "ctdet" / "chip_smoke_coco" / "model_last.pth")
    bwd = 0
    for name, fn, args in (
            ("main", cli_main.main, ["--exp_id", "chip_smoke_coco"]),
            ("quant_main", quant_main.main, ["--exp_id",
                                             "chip_smoke_coco_qat",
                                             "--load_model", fp32])):
        DC.LAUNCHES = DC.BWD_LAUNCHES = 0
        text, seconds = _cli_log(fn, data.args(TRAIN_BATCH, *common, *args))
        losses = [float(ln.split(" loss ")[1].split()[0])
                  for ln in _lines_with(text, "train epoch")]
        out["cli"][name] = {"seconds": seconds, "losses": losses,
                            "stats": _stats_lines(text),
                            "launches_fwd": DC.LAUNCHES,
                            "launches_bwd": DC.BWD_LAUNCHES}
        launches += DC.LAUNCHES
        bwd += DC.BWD_LAUNCHES
        if len(losses) != 2 or not np.all(np.isfinite(losses)) \
                or len(out["cli"][name]["stats"]) != 12 \
                or (DC.LAUNCHES, DC.BWD_LAUNCHES) != (6 + 3 * len(val), 6):
            fail.append("cli " + name)
    out["failed"] = fail
    emit(out)
    if fail:
        raise SystemExit("coco_ctdet check failed: {}".format(fail))
    return launches, bwd


def phase_multi_pose(data):
    """multi_pose (COCO keypoints) at COCO_RES^2, six heads: a batch-2
    forward card vs CPU (1e-3 of each head's max, 3 launches) and
    multi_pose_decode card vs CPU on the same flip-test heads
    (DECODE_TOL); 8 flip-test requests with their stage timers and one
    request at the five test scales with --nms (soft_nms_39); one FP32
    train step card vs CPU at batch 4 from conditioned_init (STEP_TOL);
    4 timed steps at batch 32 on sampler batches (the loader timed
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

    run = _train_and_time(data, data.opt(TRAIN_BATCH), 4, fail, out,
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
    from codenet_torch.engine.trainer import Trainer
    parity, ok = step_parity(data, conditioned_init(topt),
                             batch=parity_batch)
    out["train_parity"] = {"batch": parity_batch, **parity,
                           "tol": STEP_TOL}
    if not ok:
        fail.append("train parity")
    batches, out["loader_ms_per_batch"] = loader_batches(
        data.dataset(topt), topt.batch_size, steps, topt.num_workers,
        topt.seed)
    out["loader_workers"] = topt.num_workers
    trainer = Trainer(topt, device="cuda")
    trainer.init()
    run = timed_steps(trainer, batches)
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
    CPU at TASK_STEP_BATCH and 4 timed steps at KITTI_TRAIN_BATCH; then
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

    run = _train_and_time(data, data.opt(KITTI_TRAIN_BATCH), 4, fail, out)
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
    timers; one FP32 step card vs CPU at TASK_STEP_BATCH and 3 timed steps
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

    run = _train_and_time(data, data.opt(TRAIN_BATCH), 3, fail, out)
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


def _results_equal(a, b):
    """Two detectors' results of one request equal, class by class."""
    return list(a) == list(b) and all(
        np.array_equal(np.asarray(a[j]), np.asarray(b[j])) for j in a)


def int8_task(name, data, ckpt, extra, stats_of, want_stats, export,
              art=None):
    """Real int8 of one task from its QAT checkpoint `ckpt` (see
    phase_int8_tasks), and from its artifact `art` where one was written,
    else from the one `export` writes. Returns (its JSON entry, forward
    launches of its served and CLI paths, failed checks)."""
    from codenet_torch.cli import test as cli_test
    from codenet_torch.cli.test import _request_meta
    from codenet_torch.engine.detector import detector_factory, eval_input
    from codenet_torch.models import create_model
    from codenet_torch.models import layers as L
    from codenet_torch.ops import deform_cuda as DC
    fail = []
    out = {}
    if art is None:
        art = str(ROOT / "exp" / "chip_smoke" / "{}_w4a8.npz".format(name))
        log = io.StringIO()
        with contextlib.redirect_stdout(log):
            rc = export.main(data.args(1, "--resume-quantize",
                                       "--load_model", ckpt, "--out", art))
        out["export_log"] = log.getvalue().splitlines()[-1]
        if rc != 0:
            fail.append("export")
    out["artifact_bytes"] = Path(art).stat().st_size

    def detector(*more):
        return detector_factory(data.task)(data.opt(
            1, *extra, "--resume-quantize", "--int8_infer", *more),
            device="cuda")
    dets = {"pth": detector("--load_model", ckpt),
            "artifact": detector("--w4a8_artifact", art)}
    opt = dets["pth"].opt
    val = data.dataset(opt, "val")
    frames = [val.load_image(i) for i in range(len(val))]
    metas = [_request_meta(val, opt, i) for i in range(len(val))]
    dtypes, results, requests = [], {}, {}
    with recording(DC, "_launch",
                   lambda x, s, w: dtypes.append(str(x.dtype))):
        DC.LAUNCHES = 0  # counts from here on: the served paths
        for key, det in dets.items():
            rets = [det.run(f, m) for f, m in zip(frames, metas)]
            results[key] = [r["results"] for r in rets]
            requests[key] = [dict(_ms(r), dets=int(sum(
                len(v) for v in r["results"].values()))) for r in rets]
        served = DC.LAUNCHES
    same = all(_results_equal(a, b)
               for a, b in zip(results["pth"], results["artifact"]))
    # the decoded top-K of every request, scores below the threshold
    # included: equal even where a request serves no detection
    def decoded(det, frame, meta):
        images, meta = det.pre_process(frame, 1, meta)
        with torch.inference_mode():
            return det.process(images, meta["trans_inv"], 1)
    same_raw = all(torch.equal(decoded(dets["pth"], f, m),
                               decoded(dets["artifact"], f, m))
                   for f, m in zip(frames, metas))
    out.update(requests_ms=requests["artifact"], launches=served,
               launch_dtypes=sorted(set(dtypes)), dets_equal=same,
               decoded_equal=same_raw)
    if served != 3 * len(dets) * len(frames) \
            or set(dtypes) != {"torch.bfloat16"}:
        fail.append("launches")
    if not same:
        fail.append("pth vs artifact detections")
    if not same_raw:
        fail.append("pth vs artifact decoded top-K")

    # one request's input: card vs CPU, int8 vs act-clamp fake-quant (as
    # served, and sampling the deform conv in f32), forwards timed
    model = dets["pth"].model
    images, _ = dets["pth"].pre_process(frames[0], 1, metas[0])
    x = eval_input(dets["pth"]._to_device(images), opt.mean, opt.std)
    fake = create_model(opt.arch, opt.heads, opt.head_conv, w2=opt.w2,
                        maxpool=opt.maxpool,
                        qspec=dataclasses.replace(
                            dets["pth"].qspec, int8_infer=False,
                            act_clamp=True), device="cuda")
    fake.load_state_dict(model.state_dict())
    with torch.no_grad():
        card = model(x)
        cpu = copy.deepcopy(model).cpu()(x.cpu())
        ref = fake(x)
        L.INT8_SAMPLE_DTYPE = torch.float32
        try:
            f32 = model(x)
        finally:
            L.INT8_SAMPLE_DTYPE = torch.bfloat16
        out["net_forward_ms"] = {
            "int8": cuda_time_ms(lambda: model(x), 20),
            "fake_quant": cuda_time_ms(lambda: fake(x), 20)}
    out["input"] = list(x.shape)
    out["card_vs_cpu"] = head_errs(cpu, card)
    out["int8_vs_act_clamp"] = head_errs(ref, card)
    out["int8_f32_sampling_vs_act_clamp"] = head_errs(ref, f32)
    out["heads_finite"] = all(bool(torch.isfinite(v).all())
                              for v in card.values())
    if not out["heads_finite"] or any(
            max(out[k].values()) > INT8_TOL
            for k in ("card_vs_cpu", "int8_vs_act_clamp",
                      "int8_f32_sampling_vs_act_clamp")):
        fail.append("heads")

    DC.LAUNCHES = 0
    text, seconds = _cli_log(cli_test.main, data.args(
        1, *extra, "--resume-quantize", "--int8_infer", "--w4a8_artifact",
        art, "--exp_id", "chip_smoke_int8_" + name))
    stats = stats_of(text)
    out["cli"] = {"seconds": seconds, "stats": stats,
                  "launches": DC.LAUNCHES}
    if len(stats) != want_stats or DC.LAUNCHES != 3 * len(frames):
        fail.append("cli")
    return out, served + DC.LAUNCHES, fail


def phase_int8_tasks():
    """Real int8 (--resume-quantize --int8_infer) of ctdet on COCO (512^2,
    80 classes), multi_pose (512^2), ddd (384x1280) and exdet (512^2),
    each from the QAT checkpoint its phase wrote: the W4A8 artifact
    exported (tools_torch/export_w4a8.py, its bytes); 8 requests served
    from the .pth and 8 from the artifact (equal detections, stage
    timers, every forward launch bf16); one request's int8 heads card vs
    CPU and against the act-clamp fake-quant, as served and sampling in
    f32 (INT8_TOL of each head's max), its int8 and fake-quant forwards
    timed; `cli.test --resume-quantize --int8_infer` from the artifact
    with the task's evaluator stats. Returns the forward launches."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "export_w4a8", ROOT / "tools_torch" / "export_w4a8.py")
    export = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(export)

    def ckpt(task, exp_id):
        return str(ROOT / "exp" / task / exp_id / "model_last.pth")
    tasks = [
        ("coco_ctdet", CocoSmokeData("ctdet"),
         ckpt("ctdet", "chip_smoke_coco_qat"), ["--flip_test"],
         _stats_lines, 12),
        ("multi_pose", CocoSmokeData("multi_pose"),
         ckpt("multi_pose", "chip_smoke_pose_qat"), ["--flip_test"],
         _stats_lines, 10),
        ("ddd", KittiSmokeData(), ckpt("ddd", "chip_smoke_ddd_qat"), [],
         lambda text: _lines_with(text, ": AP2D "), 9),
        ("exdet", CocoSmokeData("exdet"),
         ckpt("exdet", "chip_smoke_exdet_qat"), ["--flip_test"],
         _stats_lines, 12)]
    out, launches, fail = {"phase": "int8_tasks"}, 0, []
    for name, data, path, extra, stats_of, want in tasks:
        out[name], n, failed = int8_task(name, data, path, extra, stats_of,
                                         want, export)
        launches += n
        fail += ["{} {}".format(name, f) for f in failed]
    out["launches"] = launches
    out["failed"] = fail
    emit(out)
    if fail:
        raise SystemExit("int8_tasks check failed: {}".format(fail))
    return launches


@torch.no_grad()
def build_arch_model(arch, device="cuda", res=COCO_RES):
    """One of CenterNet's other backbones at its published widths with
    the 80 COCO heads, random but not degenerate: every DCNv2's offset
    predictor redrawn (offsets of about a pixel, the mask off 0.5), BN
    running stats from a random batch (each channel's variance at least
    twice its layer's mean), BN scales and biases perturbed."""
    from codenet_torch.models import create_model
    gen = torch.Generator().manual_seed(SEED + 21)
    model = create_model(arch, COCO_HEADS, 256 if "dla" in arch else 64,
                         device=device, generator=gen)
    for m in model.modules():
        if hasattr(m, "conv_offset_mask"):
            w, b = m.conv_offset_mask.weight, m.conv_offset_mask.bias
            w.copy_(torch.randn(w.shape, generator=gen)
                    / w[0].numel() ** 0.5)
            b.copy_(torch.randn(b.shape, generator=gen))
    bns = [m for m in model.modules()
           if isinstance(m, torch.nn.BatchNorm2d)]
    for m in bns:
        m.reset_running_stats()
        m.momentum = None
    model.train()
    model(torch.randn(2, *_hw(res), 3, generator=gen).to(device))
    for m in bns:
        m.momentum = 0.1
        m.running_var.clamp_(min=2.0 * float(m.running_var.mean()))
        m.weight.mul_(torch.rand(m.weight.shape, generator=gen).to(device)
                      + 0.5)
        m.bias.add_(torch.randn(m.bias.shape, generator=gen).to(device)
                    * 0.1)
    return model.eval()


def arch_step_parity(data, arch):
    """One FP32 train step at TASK_STEP_BATCH on the card and on the CPU
    from conditioned_init: the loss and the gradients (relative L2 over
    all, the median tensor) within STEP_TOL; no deform kernel launched."""
    from codenet_torch.data.loader import DataLoader
    from codenet_torch.engine.trainer import Trainer, batch_to_device
    from codenet_torch.ops import deform_cuda as DC
    opt = data.opt(TASK_STEP_BATCH, arch=arch)
    batch = next(iter(DataLoader(data.dataset(opt), TASK_STEP_BATCH,
                                 shuffle=True, num_workers=4, seed=1)))
    state = conditioned_init(opt)
    card, cpu = (Trainer(opt, device=dev) for dev in ("cuda", "cpu"))
    for trainer in (card, cpu):
        trainer.model.load_state_dict(state)
        trainer.init()
    before = (DC.LAUNCHES, DC.BWD_LAUNCHES)
    got = card.train_step(batch_to_device(batch, "cuda"))
    torch.cuda.synchronize()
    launches = [DC.LAUNCHES - before[0], DC.BWD_LAUNCHES - before[1]]
    ref = cpu.train_step(batch_to_device(batch, "cpu"))
    err = grads_vs(card.model, cpu.model)
    del err["deform_tensor_rel"]
    out = {"batch": TASK_STEP_BATCH, "loss_card": float(got["loss"]),
           "loss_cpu": float(ref["loss"]),
           "loss_rel": abs(float(got["loss"]) - float(ref["loss"]))
           / abs(float(ref["loss"])), "launches_fwd_bwd": launches,
           "tol": STEP_TOL, **err}
    return out, (launches == [0, 0] and out["loss_rel"] <= STEP_TOL
                 and err["grad_rel_l2"] <= STEP_TOL
                 and err["grad_tensor_rel_median"] <= STEP_TOL)


def dcn_op_times(model, images, step_ms, iters=5):
    """The plain DCNv2 op (ops/deform_conv.py::deform_conv2d, no kernel of
    ours) of every ModulatedDeformConvPack in `model`, at the maps one
    forward of `images` gives it: per distinct (N, H, W, Cin, Cout) the
    calls, the ms of one forward and of one forward + backward (CUDA
    events, `iters` after a warm-up), and their sum over one train step
    beside `step_ms`."""
    from codenet_torch.models.deform_modules import ModulatedDeformConvPack
    from codenet_torch.ops.deform_conv import deform_conv2d
    shapes = {}

    def record(mod, inp, out):
        n, c, h, w = inp[0].shape
        key = (n, h, w, c, mod.weight.shape[0])
        shapes[key] = shapes.get(key, 0) + 1

    hooks = [m.register_forward_hook(record) for m in model.modules()
             if isinstance(m, ModulatedDeformConvPack)]
    with torch.no_grad():
        model(images)
    for h in hooks:
        h.remove()
    gen = torch.Generator().manual_seed(SEED + 23)
    rows, step_sum = [], 0.0
    for (n, h, w, c, cout), calls in sorted(shapes.items()):
        x = torch.randn(n, h, w, c, generator=gen).cuda().requires_grad_()
        off = (torch.rand(n, h, w, 18, generator=gen) * 2 - 1).cuda() \
            .requires_grad_()
        mask = torch.rand(n, h, w, 9, generator=gen).cuda().requires_grad_()
        wt = (torch.randn(3, 3, c, cout, generator=gen) * 0.05).cuda() \
            .requires_grad_()
        g = torch.randn(n, h, w, cout, generator=gen).cuda()

        def fwd():
            return deform_conv2d(x, off, wt, mask=mask)

        def fwd_bwd():
            fwd().backward(g)

        times = {}
        for name, fn in (("fwd", fwd), ("fwd_bwd", fwd_bwd)):
            with torch.no_grad() if name == "fwd" else \
                    contextlib.nullcontext():
                times[name] = cuda_time_ms(fn, iters, warmup=2)
        step_sum += calls * times["fwd_bwd"]
        rows.append({"shape_nhwc_cout": [n, h, w, c, cout], "calls": calls,
                     "ms_fwd": times["fwd"], "ms_fwd_bwd": times["fwd_bwd"]})
        del x, off, mask, wt, g
    torch.cuda.empty_cache()
    return {"maps": rows, "ms_per_step": step_sum,
            "share_of_step": step_sum / step_ms}


def phase_backbones(data):
    """CenterNet's other backbones (ARCHS) on COCO ctdet at COCO_RES^2,
    80 classes, FP32, none of which runs a deform kernel of ours. Per
    arch: a batch-2 forward card vs CPU (every stack's heads within
    ARCH_HEAD_TOL); a train step card vs CPU at batch 2 (arch_step_parity);
    ARCH_TIMED_STEPS timed steps at the arch's per-card batch with img/s
    and peak memory; 8 flip-test requests with their stage timers; for
    the DCNv2 archs the plain op's time at their maps (dcn_op_times);
    and the deform kernels' launch counts, which must stay 0. Then
    cli.main (2 steps, its final eval) -> cli.test --flip_test (12 bbox
    stats) for dla_34 with no --arch (the CLIs' default) and hourglass."""
    from codenet_torch.cli import main as cli_main
    from codenet_torch.cli import test as cli_test
    from codenet_torch.engine.detector import CtdetDetector
    from codenet_torch.engine.trainer import Trainer
    from codenet_torch.ops import deform_cuda as DC
    fail = []
    DC.LAUNCHES = DC.BWD_LAUNCHES = 0
    topt = data.opt(max(b for _, b in ARCHS), arch="res_18")
    batches, loader_ms = loader_batches(
        data.dataset(topt), topt.batch_size, ARCH_TIMED_STEPS,
        topt.num_workers, topt.seed)
    rows = {}
    for arch, batch in ARCHS:
        row = {"batch": batch}
        model = build_arch_model(arch)
        row["heads_card_vs_cpu"], ok = heads_card_vs_cpu(
            model, ARCH_HEAD_TOL, 0, res=COCO_RES)
        if not ok:
            fail.append(arch + " heads")
        row["train_parity"], ok = arch_step_parity(data, arch)
        if not ok:
            fail.append(arch + " train parity")
        opt = data.opt(batch, arch=arch)
        trainer = Trainer(opt, device="cuda")
        trainer.init()
        run = timed_steps_with_memory(trainer, [
            {k: v[:batch] for k, v in b.items() if k != "meta"}
            for b in batches])
        row["train"] = run
        if not np.all(np.isfinite(run["losses"])) or any(
                st != [0, 0] for st in run["launches_per_step"]):
            fail.append(arch + " train")
        if arch in ("resdcn_18", "dla_34"):
            images = torch.randn(batch, COCO_RES, COCO_RES, 3).cuda()
            row["dcn_op"] = dcn_op_times(
                trainer.model, images, run["ms_per_step_steady_median"])
            del images
        del trainer
        det = CtdetDetector(data.opt(1, "--flip_test", arch=arch),
                            state_dict=model.state_dict(), device="cuda")
        val = data.dataset(det.opt, "val")
        requests = []
        for i in range(len(val)):
            ret = det.run(val.load_image(i))
            requests.append(dict(_ms(ret), dets=int(sum(
                len(v) for v in ret["results"].values()))))
        row["requests_ms"] = requests
        if len(requests) != 8 or any(r["dets"] == 0 for r in requests):
            fail.append(arch + " served")
        del det, model
        torch.cuda.empty_cache()
        rows[arch] = row
    out = {"phase": "backbones", "res": COCO_RES,
           "loader_ms_per_batch": loader_ms,
           "loader_batch": topt.batch_size, "archs": rows, "cli": {}}
    del batches
    for arch in ("dla_34", "hourglass"):
        batch = dict(ARCHS)[arch]
        flag = None if arch == "dla_34" else arch  # dla_34: no --arch
        exp_id = "chip_smoke_cli_" + arch
        text, seconds = _cli_log(cli_main.main, data.args(
            batch, "--num_epochs", "1", "--num_iters", "2",
            "--val_intervals", "-1", "--print_iter", "1", "--exp_id",
            exp_id, arch=flag))
        losses = [float(ln.split(" loss ")[1].split()[0])
                  for ln in _lines_with(text, "train epoch")]
        path = ROOT / "exp" / "ctdet" / exp_id / "model_last.pth"
        keys = torch.load(path, map_location="cpu",
                          weights_only=True)["state_dict"]
        final = _stats_lines(text)
        text2, seconds2 = _cli_log(cli_test.main, data.args(
            1, "--flip_test", "--load_model", str(path), "--exp_id",
            exp_id + "_test", arch=flag))
        stats = _stats_lines(text2)
        out["cli"][arch] = {
            "arch_flag": flag, "main_seconds": seconds, "losses": losses,
            "final_eval_stats": len(final), "test_seconds": seconds2,
            "stats": stats,
            "dla_up_path": "ida_up.node_2.conv.weight" in keys}
        if (len(losses) != 2 or not np.all(np.isfinite(losses))
                or len(final) != 12 or len(stats) != 12
                or (arch == "dla_34") != ("ida_up.node_2.conv.weight"
                                          in keys)):
            fail.append("cli " + arch)
    out["launches_fwd_bwd"] = [DC.LAUNCHES, DC.BWD_LAUNCHES]
    if out["launches_fwd_bwd"] != [0, 0]:
        fail.append("deform kernel launched")
    out["failed"] = fail
    emit(out)
    if fail:
        raise SystemExit("backbones check failed: {}".format(fail))


def phase_host_io():
    """What the card's host offers for image files: the Python modules
    cv2, PIL and imageio (found, and each found one imported in a
    process of its own: its version or the error), and the shared
    libraries of libjpeg, libturbojpeg and libpng; then a 375x500 frame
    written with the port's write_png and read back with its read_png,
    held exact; where cv2 imports, tools_torch/png_read_time.py: read_png
    and cv2.imread timed on a 375x1242 frame cv2 wrote with each filter
    setting, their pixels held equal."""
    import ctypes.util
    import importlib.util
    from codenet_torch.data.image_io import read_png, write_png
    frame = synthetic_frames(1)[0][0]
    path = ROOT / "exp" / "chip_smoke" / "host_io.png"
    path.parent.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    write_png(str(path), frame)
    t1 = time.perf_counter()
    back = read_png(str(path))
    t2 = time.perf_counter()
    found = [m for m in ("cv2", "PIL", "imageio")
             if importlib.util.find_spec(m) is not None]
    imports = {}
    for m in found:
        probe = subprocess.run(
            [sys.executable, "-c", "import {0}; print({0}.__version__)"
             .format(m)], capture_output=True, text=True, timeout=120)
        imports[m] = (probe.stdout.strip() if probe.returncode == 0
                      else probe.stderr.strip().splitlines()[-1:])
    out = {"phase": "host_io",
           "modules": {m: m in found for m in ("cv2", "PIL", "imageio")},
           "imports": imports,
           "libraries": {lib: ctypes.util.find_library(lib)
                         for lib in ("jpeg", "turbojpeg", "png")},
           "frame": list(frame.shape), "png_bytes": path.stat().st_size,
           "write_ms": (t1 - t0) * 1e3, "read_ms": (t2 - t1) * 1e3,
           "exact": bool(np.array_equal(back, frame))}
    if "cv2" in imports and not isinstance(imports["cv2"], list):
        # read_png against cv2.imread on libpng-written KITTI-size frames
        timed = subprocess.run(
            [sys.executable, str(ROOT / "tools_torch" / "png_read_time.py"),
             "--dir", str(path.parent)], capture_output=True, text=True,
            timeout=300)
        out["png_read_vs_cv2"] = (json.loads(timed.stdout.splitlines()[-1])
                                  if timed.stdout else timed.stderr[-500:])
        out["png_read_equal"] = timed.returncode == 0
    emit(out)
    if not out["exact"] or not out.get("png_read_equal", True):
        raise SystemExit("host_io check failed: the PNG round trip or "
                         "read_png against cv2.imread")


def synthreg_steps(data_root, res, steps=4):
    """The regression's train step at its size (SYNTH_TRAIN_BATCH, `res`^2,
    its one loader worker): `steps` FP32 steps from the port's init and
    `steps` QAT steps from its FP32 checkpoint, timed with CUDA events
    (timed_steps), the loader timed apart."""
    from codenet_torch import config as cfg
    from codenet_torch.data.datasets import get_dataset
    from codenet_torch.engine import checkpoint
    from codenet_torch.engine.trainer import Trainer
    from codenet_torch.models.layers import QuantSpec
    opt = cfg.update_dataset_info_and_set_heads(cfg.parse(
        ["ctdet", "--dataset", "pascal", "--arch", "shufflenetv2",
         "--input_res", str(res), "--batch_size", str(SYNTH_TRAIN_BATCH),
         "--num_workers", "1", "--no_color_aug", "--data_dir",
         str(data_root)]), cfg.DATASET_SPECS["pascal"])
    batches, loader_ms = loader_batches(
        get_dataset("pascal", "ctdet")(opt, "train"), SYNTH_TRAIN_BATCH,
        steps, 1, opt.seed)
    out = {"loader_ms_per_batch": loader_ms, "batch": SYNTH_TRAIN_BATCH,
           "res": res}
    fp32 = Trainer(opt, device="cuda")
    fp32.init()
    out["fp32"] = timed_steps(fp32, batches)
    qat = Trainer(opt, qspec=QuantSpec(), device="cuda")
    with contextlib.redirect_stdout(io.StringIO()):
        checkpoint.load_model(str(ROOT / "exp" / "ctdet" /
                                  "chip_smoke_synth_fp32" /
                                  "model_last.pth"), qat.model)
    qat.init()
    out["qat"] = timed_steps(qat, batches)
    return out


def phase_synthreg():
    """The synthetic accuracy regression (tools_torch/synthetic_regression
    .py run_deltas) at its --smoke size on PNG files it writes: cli.main
    (FP32), cli.quant_main (QAT, and clamp-trained QAT), then eight
    cli.test evals, each entry point run in this process (its launches
    counted) and reading the image files (no in-memory frames), after
    the outputs of any earlier run are removed. Holds every stage's exit
    code 0, eight finite APs, the fp32 and qat_clamped APs at
    SMOKE_MIN_AP or above and the bands that hold at any training length
    (SMOKE_BANDS); reports the other deltas; then the regression's FP32 and QAT steps timed
    (synthreg_steps). Returns the (forward, backward) launches."""
    import importlib
    import importlib.util
    from codenet_torch.ops import deform_cuda as DC
    spec = importlib.util.spec_from_file_location(
        "synthetic_regression", ROOT / "tools_torch" /
        "synthetic_regression.py")
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    work = ROOT / "exp" / "chip_smoke"
    work.mkdir(parents=True, exist_ok=True)
    launches = []

    def runner(cmd):
        """[python, -m, codenet_torch.cli.<name>, *argv] -> its main(argv)
        here, its output into synthreg.log; an exception ends the
        script."""
        entry = importlib.import_module(cmd[2])
        before = (DC.LAUNCHES, DC.BWD_LAUNCHES)
        with open(work / "synthreg.log", "a") as log, \
                contextlib.redirect_stdout(log):
            entry.main(cmd[3:])
        launches.append([DC.LAUNCHES - before[0],
                         DC.BWD_LAUNCHES - before[1]])
        return 0
    # a run's marker files would let this one skip its training stages
    for old in [ROOT / "exp" / "chip_smoke_synth_data",
                *(ROOT / "exp" / "ctdet").glob("chip_smoke_synth_*")]:
        shutil.rmtree(old, ignore_errors=True)
    with images_from_files():
        payload, data_root = tool.run_deltas(
            gpus="0", exp_prefix="chip_smoke_synth", runner=runner,
            out_json=str(work / "synthreg.json"), **tool.SMOKE)
        steps = synthreg_steps(data_root, payload["config"]["input_res"])
    failed = tool.smoke_failures(payload)
    total = [sum(v[i] for v in launches) for i in (0, 1)]
    # the stages and evals ran in the order payload["seconds"] lists them
    emit({"phase": "synthreg", **payload, "smoke_bands": tool.SMOKE_BANDS,
          "smoke_min_ap": tool.SMOKE_MIN_AP,
          "launches": dict(zip(payload["seconds"], launches)),
          "launches_fwd_bwd": total, "steps": steps, "failed": failed})
    if failed or not all(total) or not all(
            np.isfinite(steps[k]["losses"]).all() for k in ("fp32", "qat")):
        raise SystemExit("synthreg check failed: {}".format(failed))
    return [total[0] + sum(steps[k]["launches_fwd"] for k in ("fp32", "qat")),
            total[1] + sum(steps[k]["launches_bwd"] for k in ("fp32", "qat"))]


# the paper's configs b-e (config a is the script's main path): input
# side, the 2x network, the pooled stem (tools_torch/run_configs_ae.py)
AE_CONFIGS = {"b": (RES, False, True), "c": (COCO_RES, False, False),
              "d": (COCO_RES, True, False), "e": (COCO_RES, True, True)}
# the 2x network's deconv maps at 512^2 (configs d and e)
W2_SHAPE = (16, 16, 2153)
W2_SHAPES = [W2_SHAPE, (32, 32, 256), (64, 64, 128)]
AE_TIMED_STEPS = 3
# the driver's smoke: its PNG set (tools_torch/synthetic_data.py) and the
# epochs of its stages (an epoch is one step: 32 train frames at batch 32;
# QAT resumes at epoch 2)
AE_SMOKE_IMAGES = (32, 8)
AE_SMOKE_ARGS = ["--fp32_epochs", "2", "--qat_epochs", "4",
                 "--device_cache", "--retries", "0"]
# the reference's published W4A8 parameter files, 1x and 2x (bytes)
REFERENCE_ARTIFACT = {False: 0.76e6, True: 2.90e6}


class ConfigSmokeData(SmokeData):
    """One of configs b-e on a synthetic VOC set: SmokeData's in-memory
    frames, or with `data_dir` a PNG set on disk; every command line
    carries the config's input side and flags."""

    def __init__(self, config, data_dir=None):
        self.res, w2, maxpool = AE_CONFIGS[config]
        self.flags = ["--w2"] * w2 + ["--maxpool"] * maxpool
        if data_dir is None:
            super().__init__()
        else:
            self.data_dir = Path(data_dir)

    def args(self, batch, *extra, arch="shufflenetv2"):
        return super().args(batch, *self.flags, *extra, arch=arch)


def configs_ae_driver(configs, work, fail):
    """tools_torch/run_configs_ae.py --smoke over `configs` on a small PNG
    set, each stage's entry point run in this process (its launches
    counted). Returns (data root, {config: [forward, backward]
    launches}, the driver's stage lines)."""
    import importlib
    import importlib.util
    from codenet_torch.ops import deform_cuda as DC
    sys.path.insert(0, str(ROOT / "tools_torch"))
    from synthetic_data import make_voc_dataset

    def tool(name):
        spec = importlib.util.spec_from_file_location(
            name, ROOT / "tools_torch" / "{}.py".format(name))
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
        return module
    driver, export = tool("run_configs_ae"), tool("export_w4a8")
    # the driver's exp dirs are the real matrix's: take over only those
    # this script made (marker .chip_smoke), so that a trained matrix in
    # this checkout is never deleted
    for name in configs:
        old = ROOT / "exp" / "ctdet" / \
            "pascal_shufflenetv2_config_{}".format(name)
        if old.exists():
            if not (old / ".chip_smoke").exists():
                raise SystemExit("configs_ae: {} holds a run this script "
                                 "did not make; move it aside".format(old))
            shutil.rmtree(old)
    root = work / "configs_ae_data"
    shutil.rmtree(root, ignore_errors=True)
    make_voc_dataset(str(root), num_images=AE_SMOKE_IMAGES[0], img_w=160,
                     img_h=120, seed=SEED, test_images=AE_SMOKE_IMAGES[1])
    launches, current = {}, []

    def runner(cmd):
        """[python, -m, codenet_torch.cli.<name>, *argv] or [python,
        tools_torch/export_w4a8.py, *argv] -> its main(argv) here, its
        output into configs_ae.log; an exception ends the script."""
        if cmd[1] == "-m":
            entry, argv = importlib.import_module(cmd[2]).main, cmd[3:]
        else:
            entry, argv = export.main, cmd[2:]
        before = (DC.LAUNCHES, DC.BWD_LAUNCHES)
        with open(work / "configs_ae.log", "a") as log, \
                contextlib.redirect_stdout(log):
            rc = entry(argv)
        counts = launches.setdefault(current[0], [0, 0])
        counts[0] += DC.LAUNCHES - before[0]
        counts[1] += DC.BWD_LAUNCHES - before[1]
        # the CLIs return their trainer or detector, the export tool its
        # exit code
        return rc if isinstance(rc, int) else 0
    lines = []
    for name in configs:
        current[:] = [name]
        log = io.StringIO()
        with contextlib.redirect_stdout(log), images_from_files():
            rc = driver.main(["--configs", name, "--data_dir", str(root),
                              "--smoke", *AE_SMOKE_ARGS], runner=runner)
        lines += [json.loads(ln) for ln in log.getvalue().splitlines()
                  if ln.startswith("{")]
        exp_dir = ROOT / "exp" / "ctdet" / \
            "pascal_shufflenetv2_config_{}".format(name)
        (exp_dir / ".chip_smoke").write_text("")
        if rc != 0:
            fail.append("{} driver rc {}".format(name, rc))
    return root, launches, lines


def phase_configs_ae():
    """The paper's configs b-e (config a is the main path's), each at its
    input side with the full-width 1x or 2x network: a served batch-2
    forward card vs CPU (1e-3 of each head's max, 3 launches); FP32 and
    QAT (--wt-percentile --act_clamp) train steps at batch 32 from the
    port's init, AE_TIMED_STEPS each timed with CUDA events, with peak
    memory; for config d one FP32 step card vs CPU at batch 2 from
    conditioned_init (STEP_TOL: the 2153-channel backward in a real
    step); 8 flip-test requests with their stage timers. Then
    tools_torch/run_configs_ae.py --smoke over b-e on a PNG set (FP32 ->
    QAT -> fake-quant and int8 evals -> export, each stage one step or
    one eval) and, from each config's QAT checkpoint and the driver's
    artifact (int8_task): equal detections and decoded top-K from the
    .pth and the artifact, int8 heads card vs CPU and against the
    act-clamp fake-quant (INT8_TOL), the int8 and fake-quant forwards
    timed, `cli.test --int8_infer` from the artifact, and the artifact's
    bytes beside the reference's. Returns the (forward, backward)
    launches."""
    from codenet_torch.engine.detector import CtdetDetector
    from codenet_torch.engine.trainer import Trainer
    from codenet_torch.models.layers import QuantSpec
    from codenet_torch.ops import deform_cuda as DC
    out, fail = {"phase": "configs_ae"}, []
    total = [0, 0]
    batches = {}
    for name, (res, w2, maxpool) in AE_CONFIGS.items():
        entry = {"res": res, "w2": w2, "maxpool": maxpool}
        out[name] = entry
        model = build_served_model(res=res, w2=w2, maxpool=maxpool)
        DC.LAUNCHES = DC.BWD_LAUNCHES = 0
        fwd, ok = heads_card_vs_cpu(model, 1e-3, 3, res=res)
        entry["heads_card_vs_cpu"] = fwd
        if not ok:
            fail.append(name + " heads")

        data = ConfigSmokeData(name)
        opt = data.opt(TRAIN_BATCH)
        if res not in batches:
            batches[res] = loader_batches(data.dataset(opt), opt.batch_size,
                                          AE_TIMED_STEPS, opt.num_workers,
                                          opt.seed)
        steps, entry["loader_ms_per_batch"] = batches[res]
        fp32 = Trainer(opt, device="cuda")
        fp32.init()
        entry["fp32"] = timed_steps_with_memory(fp32, steps)
        qat = Trainer(opt, qspec=QuantSpec(wt_percentile=True,
                                           act_clamp=True), device="cuda")
        qat.model.load_state_dict(fp32.model.state_dict(), strict=False)
        qat.init()
        entry["qat"] = timed_steps_with_memory(qat, steps)
        del fp32, qat
        for key in ("fp32", "qat"):
            if not np.all(np.isfinite(entry[key]["losses"])) or any(
                    st != [3, 3] for st in entry[key]["launches_per_step"]):
                fail.append("{} {} steps".format(name, key))
        if name == "d":
            parity, ok = step_parity(data, conditioned_init(opt), batch=2)
            entry["train_parity"] = {"batch": 2, **parity, "tol": STEP_TOL}
            if not ok:
                fail.append("d train parity")

        det = CtdetDetector(data.opt(1, "--flip_test"),
                            state_dict=model.state_dict(), device="cuda")
        val = data.dataset(det.opt, "val")
        rets = [det.run(val.load_image(i)) for i in range(len(val))]
        entry["requests_ms"] = [dict(_ms(r), dets=int(sum(
            len(v) for v in r["results"].values()))) for r in rets]
        total[0] += DC.LAUNCHES
        total[1] += DC.BWD_LAUNCHES
        if not all(np.isfinite(v).all() for r in rets
                   for v in r["results"].values()):
            fail.append(name + " requests")
        del model, det
        torch.cuda.empty_cache()

    work = ROOT / "exp" / "chip_smoke"
    t0 = time.perf_counter()
    root, launches, lines = configs_ae_driver(list(AE_CONFIGS), work, fail)
    out["driver"] = {"seconds": time.perf_counter() - t0,
                     "args": AE_SMOKE_ARGS, "images": AE_SMOKE_IMAGES,
                     "stages": lines, "launches": launches}
    for name, (res, w2, maxpool) in AE_CONFIGS.items():
        counts = launches.get(name, [0, 0])
        total = [a + b for a, b in zip(total, counts)]
        # FP32 and QAT: two steps each (an epoch is one batch) and a
        # final eval of the val frames; the two flip-test evals, the int8
        # one deriving its weights with one more forward; the export's
        # capture forward
        want = [3 * (4 * AE_SMOKE_IMAGES[1] + 4 + 1 + 1), 3 * 4]
        if counts != want:
            fail.append("{} driver launches {} (want {})".format(
                name, counts, want))
        exp_dir = ROOT / "exp" / "ctdet" / \
            "pascal_shufflenetv2_config_{}".format(name)
        data = ConfigSmokeData(name, root)
        with images_from_files():
            entry, n, failed = int8_task(
                name, data, str(exp_dir / "model_last.pth"),
                ["--flip_test"], lambda text: _lines_with(text, "Mean AP"),
                1, None, art=str(exp_dir / "model_w4a8.npz"))
        total[0] += n
        entry["reference_artifact_bytes"] = REFERENCE_ARTIFACT[w2]
        out[name]["int8"] = entry
        fail += ["{} int8 {}".format(name, f) for f in failed]
    out["launches"] = total
    out["failed"] = fail
    emit(out)
    if fail:
        raise SystemExit("configs_ae check failed: {}".format(fail))
    return total


# -- data parallelism (ddp) ------------------------------------------------

DDP_STEPS = 3          # FP32 and QAT steps of part (b), held to one process
DDP_TIMED_STEPS = 4    # FP32 and QAT steps of part (a), timed
DDP_QAT = ("--wt-percentile", "--act_clamp")


@contextlib.contextmanager
def _rank_log(dp, out_dir):
    """A ddp rank prints into out_dir/rank<k>.log, not the script's
    output."""
    path = Path(out_dir) / "rank{}.log".format(dp.rank)
    with open(path, "w") as f, contextlib.redirect_stdout(f):
        yield


def _ddp_setup(dp, res):
    """A ddp rank's process: TF32 off, the smoke set's frames in memory
    (the parent wrote its annotations), the CPU threads shared."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    if dp.device.type == "cpu":
        torch.set_num_threads(1)
    data = SmokeData(write=False)
    data.res = res
    return data


def _timed(dp, fn):
    """fn() and its ms: CUDA events on a card, the host clock on the CPU."""
    if dp.device.type != "cuda":
        t0 = time.perf_counter()
        return fn(), (time.perf_counter() - t0) * 1e3
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize(dp.device)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize(dp.device)
    return out, start.elapsed_time(end)


def _rank_batches(data, opt, dp, n, shard_ranges=None, cache_dims=None):
    """This rank's rows of the first n global batches of the shuffled
    loader (all rows with dp None; on a data x spatial grid, its data
    row's rows); with `cache_dims` (an ImageCache's), image cache
    batches."""
    from codenet_torch.data.loader import DataLoader
    from codenet_torch.parallel import process_batch_slice
    rows = process_batch_slice(opt.batch_size, dp.data_rank,
                               dp.data_world) if dp is not None else None
    ds = data.dataset(opt)
    if cache_dims is not None:
        ds._image_cache_dims = cache_dims
    loader = DataLoader(ds, opt.batch_size, shuffle=True,
                        num_workers=opt.num_workers, seed=opt.seed,
                        shard_ranges=shard_ranges, rows=rows)
    batches = []
    while len(batches) < n:
        batches.extend(loader)
    return batches[:n]


def _sharded_cache(data, opt, dp):
    """The train split's cache with this rank's rows on its device."""
    from codenet_torch.data.device_cache import ImageCache
    cache = ImageCache.build(data.dataset(opt))
    rows = cache.to_device(dp.device, shard=True, dp=dp)
    return cache, rows


def _ddp_nccl_rank(dp, res, batch, out_dir):
    with _rank_log(dp, out_dir):
        _ddp_nccl_body(dp, res, batch, out_dir)


def _ddp_nccl_body(dp, res, batch, out_dir):
    """Part (a), one rank of the NCCL group over every visible card: the
    main path at config a with --device_cache_shard. Timed FP32 steps,
    then QAT (--wt-percentile --act_clamp) steps from them, each fed this
    rank's rows from its cache shard; then cli.main's and
    cli.quant_main's training (run_training, this rank's) for 2 steps
    each, rank 0 ending each in the final eval. Writes rank<k>.json."""
    from codenet_torch import config as cfg
    from codenet_torch.cli.main import run_training
    from codenet_torch.engine.trainer import Trainer
    from codenet_torch.models.layers import QuantSpec
    from codenet_torch.ops import deform_cuda as DC
    data = _ddp_setup(dp, res)
    opt = data.opt(batch, "--device_cache_shard")
    cache, rows = _sharded_cache(data, opt, dp)
    batches = _rank_batches(data, opt, dp, DDP_TIMED_STEPS,
                            cache.shard_ranges, cache.dims)
    out = {"rank": dp.rank, "world": dp.world, "backend": dp.backend,
           "device": str(dp.device), "batch_per_rank": batch // dp.world,
           "cache_rows": int(rows.shape[0]),
           "cache_shard_mib": rows.numel() / 2 ** 20}
    DC.LAUNCHES = DC.BWD_LAUNCHES = 0  # the main path's launches, this rank
    state = None
    for name, qspec in (("fp32", None),
                        ("qat", QuantSpec(wt_percentile=True,
                                          act_clamp=True))):
        trainer = Trainer(opt, qspec=qspec, dp=dp)
        if state is not None:
            trainer.model.load_state_dict(state, strict=False)
        trainer.init()
        trainer.image_cache, trainer.cache_shard_rows = rows, \
            cache.shard_rows
        if dp.device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dp.device)
        ms, losses = [], []
        for b in batches:
            stats, t = _timed(dp, lambda: trainer.run_epoch("train", 1,
                                                            [b]))
            ms.append(t)
            losses.append(stats["loss"])
        out[name] = {"ms_per_step": ms,
                     "ms_per_step_steady_median": float(np.median(ms[1:])),
                     "losses": losses}
        if dp.device.type == "cuda":
            out[name]["peak_mib"] = \
                torch.cuda.max_memory_allocated(dp.device) / 2 ** 20
        state = trainer.model.state_dict()
        del trainer
    out["timed_launches"] = [DC.LAUNCHES, DC.BWD_LAUNCHES]
    ckpt = ROOT / "exp" / "ctdet" / "chip_smoke_ddp_fp32" / "model_last.pth"
    common = ["--num_epochs", "1", "--num_iters", "2", "--val_intervals",
              "-1", "--print_iter", "1", "--device_cache_shard",
              "--gpus", "-1" if dp.device.type == "cpu" else "0"]
    log = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(log):
        run_training(cfg.parse(data.args(
            batch, *common, "--exp_id", "chip_smoke_ddp_fp32")), None, dp)
        run_training(cfg.parse(data.args(
            batch, *common, *DDP_QAT, "--exp_id", "chip_smoke_ddp_qat",
            "--load_model", str(ckpt))),
            QuantSpec(wt_percentile=True, act_clamp=True), dp)
    text = log.getvalue()
    out["cli"] = {"seconds": time.perf_counter() - t0,
                  "losses": [float(ln.split(" loss ")[1].split()[0])
                             for ln in text.splitlines()
                             if ln.startswith("train epoch")],
                  "mean_ap": _lines_with(text, "Mean AP"),
                  "cache_lines": _lines_with(text, "device_cache:")}
    out["launches"] = [DC.LAUNCHES, DC.BWD_LAUNCHES]
    (Path(out_dir) / "rank{}.json".format(dp.rank)).write_text(
        json.dumps(out))


def _ddp_steps(data, opt, dp, state, qspec, n, device, batches=None):
    """n train steps from `state` on this rank's rows (dp None: the whole
    batches, in one process; --spatial_shard in opt: on the grid), or on
    `batches`, this rank's rows already: losses, ms per step, the peak
    memory on a card, the final state."""
    from codenet_torch.engine.trainer import Trainer, batch_to_device
    trainer = Trainer(opt, qspec=qspec, device=device, dp=dp)
    trainer.model.load_state_dict(state, strict=qspec is None)
    trainer.init()
    timing = dp or types.SimpleNamespace(device=torch.device(device))
    on_card = timing.device.type == "cuda"
    if on_card:
        torch.cuda.synchronize(timing.device)
        torch.cuda.reset_peak_memory_stats(timing.device)
    losses, ms = [], []
    for b in batches or _rank_batches(data, opt, trainer.dp, n):
        dev = batch_to_device(b, trainer.device)
        stats, t = _timed(timing, lambda: trainer.train_step(dev))
        losses.append(float(stats["loss"]))
        ms.append(t)
    out = {"losses": losses, "ms_per_step": ms,
           "state": {k: v.detach().cpu() for k, v in
                     trainer.model.state_dict().items()}}
    if on_card:
        out["peak_mib"] = \
            torch.cuda.max_memory_allocated(timing.device) / 2 ** 20
    return out


def _ddp_cache_step(data, opt, dp, state, device):
    """One --device_cache_shard step through Trainer.run_epoch (dp None:
    the unsharded cache in one process): the stats and the state."""
    from codenet_torch.data.device_cache import ImageCache
    from codenet_torch.engine.trainer import Trainer
    trainer = Trainer(opt, device=device, dp=dp)
    trainer.model.load_state_dict(state)
    trainer.init()
    if dp is not None:
        cache, trainer.image_cache = _sharded_cache(data, opt, dp)
        trainer.cache_shard_rows = cache.shard_rows
        ranges = cache.shard_ranges
    else:
        cache = ImageCache.build(data.dataset(opt))
        trainer.image_cache = cache.to_device(device)
        # the ranks' routing: DDP_GLOO_WORLD shards of ceil(n / world)
        n = len(cache.dims)
        rps = -(-n // DDP_GLOO_WORLD)
        ranges = [(min(s * rps, n), min((s + 1) * rps, n))
                  for s in range(DDP_GLOO_WORLD)]
    batch = _rank_batches(data, opt, dp, 1, ranges, cache.dims)[0]
    stats = trainer.run_epoch("train", 1, [batch])
    return {"stats": stats, "state": {
        k: v.detach().cpu() for k, v in trainer.model.state_dict().items()}}


DDP_GLOO_WORLD = 2


def _ddp_gloo_rank(dp, res, batch, out_dir, build_dir):
    with _rank_log(dp, out_dir):
        _ddp_gloo_body(dp, res, batch, out_dir, build_dir)


def _ddp_gloo_body(dp, res, batch, out_dir, build_dir):
    """Part (b), one of two gloo ranks sharing a device: first the kernels'
    build, raced by both ranks into an empty directory; then DDP_STEPS
    FP32 and DDP_STEPS QAT steps from the conditioned init on this
    rank's rows of the global batches, and one --device_cache_shard
    step. Writes rank<k>.pt."""
    from codenet_torch.models.layers import QuantSpec
    from codenet_torch.ops import deform_cuda as DC
    data = _ddp_setup(dp, res)
    out = {"rank": dp.rank, "world": dp.world, "backend": dp.backend,
           "device": str(dp.device)}
    if dp.device.type == "cuda":
        DC.BUILD_DIR = Path(build_dir)
        t0 = time.perf_counter()
        out["build"] = {name: {"cached": b["cached"],
                               "seconds": b["seconds"]}
                        for name, b in DC.build().items()}
        out["build_seconds"] = time.perf_counter() - t0
    opt = data.opt(batch)
    state = conditioned_init(opt)
    DC.LAUNCHES = DC.BWD_LAUNCHES = 0  # the main path's launches, this rank
    out["fp32"] = _ddp_steps(data, opt, dp, state, None, DDP_STEPS,
                             dp.device)
    out["qat"] = _ddp_steps(data, opt, dp, state,
                            QuantSpec(wt_percentile=True, act_clamp=True),
                            DDP_STEPS, dp.device)
    out["cache"] = _ddp_cache_step(
        data, data.opt(batch, "--device_cache_shard"), dp, state,
        dp.device)
    out["launches"] = [DC.LAUNCHES, DC.BWD_LAUNCHES]
    torch.save(out, Path(out_dir) / "rank{}.pt".format(dp.rank))


def _rel_l2(got, ref, keys):
    num = sum(float(((got[k].double() - ref[k].double()) ** 2).sum())
              for k in keys)
    den = sum(float((ref[k].double() ** 2).sum()) for k in keys)
    return (num / den) ** 0.5


def phase_ddp(data, res=RES, batch=TRAIN_BATCH, nccl_devices=None,
              gloo_device="cuda:0"):
    """Data parallelism (codenet_torch/parallel/): (a) an NCCL group over
    every visible card trains config a with --device_cache_shard (timed
    FP32 and QAT steps, then cli.main's and cli.quant_main's training);
    (b) two gloo ranks sharing one card race the kernels' first build,
    then train DDP_STEPS FP32 and DDP_STEPS QAT steps from the conditioned
    init on the global batches of one process, held to that process's
    steps on the card (losses, and parameters in relative L2, within
    STEP_TOL) with the ranks' states bit-equal, and one
    --device_cache_shard step; (c) every rank's kernel launches, counted
    in its own process, returned for the kernels line."""
    from codenet_torch.models.layers import QuantSpec
    from codenet_torch.parallel import launch
    work = ROOT / "exp" / "chip_smoke" / "ddp"
    shutil.rmtree(work, ignore_errors=True)
    for sub in ("a", "b", "build"):
        (work / sub).mkdir(parents=True)
    nccl_devices = nccl_devices or ["cuda:{}".format(k) for k in
                                    range(torch.cuda.device_count())]
    fail = []
    t0 = time.perf_counter()
    launch(_ddp_nccl_rank, nccl_devices, args=(res, batch, str(work / "a")))
    a = [json.loads((work / "a" / "rank{}.json".format(k)).read_text())
         for k in range(len(nccl_devices))]
    a_seconds = time.perf_counter() - t0
    # FP32 and QAT: DDP_TIMED_STEPS steps each, then 2 + 2 CLI steps; rank
    # 0 adds the two final evals (flip test over the 8 val frames)
    steps = 2 * DDP_TIMED_STEPS + 4
    for r in a:
        evals = 2 * 8 if r["rank"] == 0 else 0
        if r["launches"] != [3 * (steps + evals), 3 * steps]:
            fail.append("a rank {} launches {}".format(r["rank"],
                                                       r["launches"]))
        if not np.all(np.isfinite(r["fp32"]["losses"] + r["qat"]["losses"]
                                  + r["cli"]["losses"])):
            fail.append("a rank {} losses".format(r["rank"]))
    if len(a[0]["cli"]["mean_ap"]) != 2 or len(a[0]["cli"]["losses"]) != 4:
        fail.append("a cli")

    t0 = time.perf_counter()
    launch(_ddp_gloo_rank, [gloo_device] * DDP_GLOO_WORLD, backend="gloo",
           args=(res, batch, str(work / "b"), str(work / "build")))
    b = [torch.load(work / "b" / "rank{}.pt".format(k), weights_only=False)
         for k in range(DDP_GLOO_WORLD)]
    b_seconds = time.perf_counter() - t0
    opt = data.opt(batch)
    state = conditioned_init(opt)
    qspec = QuantSpec(wt_percentile=True, act_clamp=True)
    ref = {"fp32": _ddp_steps(data, opt, None, state, None, DDP_STEPS,
                              gloo_device),
           "qat": _ddp_steps(data, opt, None, state, qspec, DDP_STEPS,
                             gloo_device),
           "cache": _ddp_cache_step(
               data, data.opt(batch, "--device_cache_shard"), None, state,
               gloo_device)}
    held = {}
    for part in ("fp32", "qat", "cache"):
        got, want = b[0][part], ref[part]
        equal = all(torch.equal(got["state"][k], b[1][part]["state"][k])
                    for k in want["state"])
        params = [k for k, v in want["state"].items()
                  if v.is_floating_point()]
        losses = got.get("losses", [got.get("stats", {}).get("loss")])
        ref_losses = want.get("losses",
                              [want.get("stats", {}).get("loss")])
        loss_rel = max(abs(x - y) / abs(y)
                       for x, y in zip(losses, ref_losses))
        rel = _rel_l2(got["state"], want["state"], params)
        held[part] = {"ranks_bit_equal": equal, "loss_rel": loss_rel,
                      "state_rel_l2": rel, "losses": losses,
                      "losses_one_process": ref_losses}
        if part != "cache":
            held[part]["ms_per_step_ranks"] = [r[part]["ms_per_step"]
                                               for r in b]
            held[part]["ms_per_step_one_process"] = want["ms_per_step"]
        if not equal or loss_rel > STEP_TOL or rel > STEP_TOL:
            fail.append("b {}".format(part))
    for r in b:
        if r["launches"] != [3 * (2 * DDP_STEPS + 1)] * 2:
            fail.append("b rank {} launches {}".format(r["rank"],
                                                       r["launches"]))
    out = {"phase": "ddp", "a": {"seconds": a_seconds, "ranks": a},
           "b": {"seconds": b_seconds, "world": DDP_GLOO_WORLD,
                 "backend": b[0]["backend"], "device": b[0]["device"],
                 "build": [r.get("build") for r in b],
                 "build_seconds": [r.get("build_seconds") for r in b],
                 "held": held, "tol": STEP_TOL},
           "launches": {"a": [r["launches"] for r in a],
                        "b": [r["launches"] for r in b]},
           "failed": fail}
    emit(out)
    if fail:
        raise SystemExit("ddp check failed: {}".format(fail))
    return (sum(r["launches"][0] for r in a + b),
            sum(r["launches"][1] for r in a + b))


# -- --spatial_shard: image rows split over a data x spatial grid --------

SPATIAL_STEPS = 3      # FP32 and QAT steps of each grid, held to one process
SPATIAL_GRIDS = (("dp1xsp2", 2), ("dp2xsp2", 4))  # gloo ranks on one card


def _spatial_rank(dp, res, batch, out_dir, full):
    with _rank_log(dp, out_dir):
        _spatial_body(dp, res, batch, out_dir, full)


def _spatial_cache_step(data, opt, dp, state, device, batch=None):
    """One --device_cache step through Trainer.run_epoch from `state` (dp
    None: one process) on `batch` (this rank's rows of the first cache
    batch; None: drawn here): on the grid each rank holds the whole cache
    and warps its band of rows of its data row's images. The stats, the
    state and the batch."""
    from codenet_torch.data.device_cache import ImageCache
    from codenet_torch.engine.trainer import Trainer
    trainer = Trainer(opt, device=device, dp=dp)
    trainer.model.load_state_dict(state)
    trainer.init()
    cache = ImageCache.build(data.dataset(opt))
    trainer.image_cache = cache.to_device(device)
    if batch is None:
        batch = _rank_batches(data, opt, trainer.dp, 1, None,
                              cache.dims)[0]
    stats = trainer.run_epoch("train", 1, [batch])
    return {"stats": stats, "batch": batch, "state": {
        k: v.detach().cpu() for k, v in trainer.model.state_dict().items()}}


def _data_rows(batch, dp):
    """The rows of a global batch that the data row of `dp` (a grid
    DataParallel) trains on."""
    from codenet_torch.parallel import process_batch_slice
    lo, hi = process_batch_slice(len(batch["reg_mask"]), dp.data_rank,
                                 dp.data_world)
    return {k: v[lo:hi] for k, v in batch.items() if k != "meta"}


def _spatial_body(dp, res, batch, out_dir, full):
    """One rank of a --spatial_shard 2 grid: SPATIAL_STEPS FP32 and
    SPATIAL_STEPS QAT steps of config a from the conditioned init on its
    data row's rows of the parent's global batches (out_dir's parent,
    batches.pt), each on its band of the images' rows; with `full`, also
    one --device_cache step and cli.main's training (2 steps, rank 0
    ending in the final eval). Writes rank<k>.pt with this process's
    launches and each part's seconds."""
    from codenet_torch import config as cfg
    from codenet_torch.cli.main import run_training
    from codenet_torch.models.layers import QuantSpec
    from codenet_torch.ops import deform_cuda as DC
    t0 = time.perf_counter()
    seconds = {}

    def lap(name):
        seconds[name] = time.perf_counter() - t0 - sum(seconds.values())
    data = _ddp_setup(dp, res)
    state = conditioned_init(data.opt(batch))
    opt = data.opt(batch, "--spatial_shard", "2")
    grid = dataclasses.replace(dp, spatial=2)  # its coordinates alone
    shared = torch.load(Path(out_dir).parent / "batches.pt",
                        weights_only=False)
    rows = [_data_rows(b, grid) for b in shared["batches"]]
    out = {"rank": dp.rank, "world": dp.world, "backend": dp.backend,
           "device": str(dp.device)}
    lap("setup")
    DC.LAUNCHES = DC.BWD_LAUNCHES = 0  # the main path's launches, this rank
    out["fp32"] = _ddp_steps(data, opt, dp, state, None, SPATIAL_STEPS,
                             dp.device, rows)
    lap("fp32")
    out["qat"] = _ddp_steps(data, opt, dp, state,
                            QuantSpec(wt_percentile=True, act_clamp=True),
                            SPATIAL_STEPS, dp.device, rows)
    lap("qat")
    if full:
        out["cache"] = _spatial_cache_step(
            data, data.opt(batch, "--device_cache", "--spatial_shard", "2"),
            dp, state, dp.device, _data_rows(shared["cache_batch"], grid))
        del out["cache"]["batch"]
        lap("cache")
        log = io.StringIO()
        with contextlib.redirect_stdout(log):
            run_training(cfg.parse(data.args(
                batch, "--num_epochs", "1", "--num_iters", "2",
                "--val_intervals", "-1", "--print_iter", "1",
                "--spatial_shard", "2", "--gpus",
                "-1" if dp.device.type == "cpu" else "0",
                "--exp_id", "chip_smoke_spatial")), None, dp)
        text = log.getvalue()
        lap("cli")
        out["cli"] = {"seconds": seconds["cli"],
                      "losses": [float(ln.split(" loss ")[1].split()[0])
                                 for ln in text.splitlines()
                                 if ln.startswith("train epoch")],
                      "mean_ap": _lines_with(text, "Mean AP")}
    out["launches"] = [DC.LAUNCHES, DC.BWD_LAUNCHES]
    out["seconds"] = seconds
    torch.save(out, Path(out_dir) / "rank{}.pt".format(dp.rank))


def _held(ranks, ref, parts):
    """Each part of the ranks' runs against one process's: the ranks'
    states bit-equal, the losses (relative) and every parameter and
    statistic (relative L2), and the per-step times and peak memory side
    by side."""
    held = {}
    for part in parts:
        got, want = ranks[0][part], ref[part]
        equal = all(torch.equal(got["state"][k], r[part]["state"][k])
                    for r in ranks[1:] for k in want["state"])
        losses = got.get("losses", [got.get("stats", {}).get("loss")])
        ref_losses = want.get("losses",
                              [want.get("stats", {}).get("loss")])
        floats = [k for k, v in want["state"].items()
                  if v.is_floating_point()]
        held[part] = {
            "ranks_bit_equal": equal,
            "loss_rel": max(abs(x - y) / abs(y)
                            for x, y in zip(losses, ref_losses)),
            "state_rel_l2": _rel_l2(got["state"], want["state"], floats),
            "losses": losses, "losses_one_process": ref_losses}
        if "ms_per_step" in want:
            held[part].update(
                ms_per_step_ranks=[r[part]["ms_per_step"] for r in ranks],
                ms_per_step_one_process=want["ms_per_step"],
                peak_mib_ranks=[r[part].get("peak_mib") for r in ranks],
                peak_mib_one_process=want.get("peak_mib"))
    return held


def phase_spatial(data, res=RES, batch=TRAIN_BATCH, device="cuda:0"):
    """--spatial_shard 2 (parallel/mesh.py's grid, halo_rows and
    gather_rows): (a) gloo ranks sharing one card as dp 1 x sp 2 and dp
    2 x sp 2 each train SPATIAL_STEPS FP32 and SPATIAL_STEPS QAT steps of
    config a at RES^2, batch `batch`, from the conditioned init, held to
    one process on the card (losses, and parameters and statistics in
    relative L2, within STEP_TOL) with every rank's state bit-equal, each
    rank's ms per step and peak memory beside one process's; (b) the dp
    1 x sp 2 ranks take one --device_cache step, held the same way, and
    (c) train through cli.main --spatial_shard 2 for one two-step epoch,
    rank 0 ending in the final eval; (d) where two cards are visible, the
    dp 1 x sp 2 steps of (a) over NCCL across them. Every rank's kernel
    launches, counted in its own process, are returned for the kernels
    line."""
    from codenet_torch.models.layers import QuantSpec
    from codenet_torch.parallel import launch
    work = ROOT / "exp" / "chip_smoke" / "spatial"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    fail, runs = [], {}
    opt = data.opt(batch)
    state = conditioned_init(opt)
    qspec = QuantSpec(wt_percentile=True, act_clamp=True)
    # the global batches, drawn once: the ranks load their rows of them
    batches = _rank_batches(data, opt, None, SPATIAL_STEPS)
    ref = {"fp32": _ddp_steps(data, opt, None, state, None, SPATIAL_STEPS,
                              device, batches),
           "qat": _ddp_steps(data, opt, None, state, qspec, SPATIAL_STEPS,
                             device, batches),
           "cache": _spatial_cache_step(
               data, data.opt(batch, "--device_cache"), None, state,
               device)}
    torch.save({"batches": batches, "cache_batch": ref["cache"]["batch"]},
               work / "batches.pt")
    grids = [(name, [device] * world, "gloo", name == "dp1xsp2")
             for name, world in SPATIAL_GRIDS]
    if torch.cuda.device_count() >= 2:
        grids.append(("nccl_dp1xsp2", ["cuda:0", "cuda:1"], "nccl", False))
    cli_steps = 2
    for name, devices, backend, full in grids:
        (work / name).mkdir(parents=True)
        t0 = time.perf_counter()
        launch(_spatial_rank, devices, backend=backend,
               args=(res, batch, str(work / name), full))
        ranks = [torch.load(work / name / "rank{}.pt".format(k),
                            weights_only=False)
                 for k in range(len(devices))]
        parts = ("fp32", "qat", "cache") if full else ("fp32", "qat")
        held = _held(ranks, ref, parts)
        run = {"seconds": time.perf_counter() - t0, "world": len(devices),
               "backend": backend, "devices": devices, "held": held,
               "launches": [r["launches"] for r in ranks],
               "rank_seconds": [r["seconds"] for r in ranks]}
        for part, h in held.items():
            if not h["ranks_bit_equal"] or h["loss_rel"] > STEP_TOL \
                    or h["state_rel_l2"] > STEP_TOL:
                fail.append("{} {}".format(name, part))
        steps = 2 * SPATIAL_STEPS + (1 + cli_steps if full else 0)
        for r in ranks:
            evals = 8 if full and r["rank"] == 0 else 0
            if r["launches"] != [3 * (steps + evals), 3 * steps]:
                fail.append("{} rank {} launches {}".format(
                    name, r["rank"], r["launches"]))
        if full:
            cli = ranks[0]["cli"]
            run["cli"] = cli
            if len(cli["losses"]) != cli_steps or len(cli["mean_ap"]) != 1 \
                    or not np.all(np.isfinite(cli["losses"])):
                fail.append("{} cli".format(name))
        runs[name] = run
    out = {"phase": "spatial", "res": res, "batch": batch, "tol": STEP_TOL,
           "runs": runs, "nccl": "ran across 2 cards" if "nccl_dp1xsp2"
           in runs else "not run: {} card(s) visible".format(
               torch.cuda.device_count()),
           "failed": fail}
    emit(out)
    if fail:
        raise SystemExit("spatial check failed: {}".format(fail))
    launches = [r for run in runs.values() for r in run["launches"]]
    return sum(x[0] for x in launches), sum(x[1] for x in launches)


# -- the profiler trace, the dense targets, the ladder and the ops ---------

TRACE_STEPS = 3        # traced cli.main steps of config a at TRAIN_BATCH
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
DENSE_TIMED_STEPS = 6  # config a --mse_loss --dense_wh, host and cache
POSE_DENSE_STEPS = 4   # multi_pose --mse_loss --dense_hp at 512^2
DENSE_TASK_BATCH = 4   # ddd and exdet with --mse_loss, one step each
LADDER_TOL = 1e-4


def trace_summary(path):
    """A profiler trace file (utils/profile.py::trace): its kernel events,
    those of each deform kernel, the 10 device ops with the most total
    time, and the device's busy share of the span from its first device
    event to its last (the union of kernel, copy and memset intervals
    over that span)."""
    events = json.loads(Path(path).read_text())["traceEvents"]
    dev = [e for e in events if e.get("cat") in DEVICE_CATS and "dur" in e]
    by_name = {}
    for e in dev:
        by_name[e["name"]] = by_name.get(e["name"], 0.0) + float(e["dur"])
    spans = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]))
                   for e in dev)
    busy, end = 0.0, None
    for a, b in spans:
        if end is None or a > end:
            busy += b - a
            end = b
        elif b > end:
            busy += b - end
            end = b
    window = spans[-1][1] - spans[0][0] if spans else 0.0
    names = [e["name"] for e in dev if e["cat"] == "kernel"]
    return {"file": Path(path).name, "kernels": len(names),
            "fwd_kernels": sum("codesign_deform_fwd_kernel" in n
                               for n in names),
            "bwd_kernels": sum("codesign_deform_bwd_kernel" in n
                               for n in names),
            "device_events": len(dev), "busy_us": busy, "span_us": window,
            "busy_share": busy / window if window else 0.0,
            "top10_device_us": [[n[:100], us] for n, us in sorted(
                by_name.items(), key=lambda kv: -kv[1])[:10]]}


def phase_trace(data):
    """--trace on the card (utils/profile.py): `cli.main --trace` on config
    a at batch 32, TRACE_STEPS steps (its final eval of the 8 val frames
    traced too, as in the JAX package), then `cli.test --trace
    --flip_test` over the 8 val frames, each in this process so that the
    launch counters see the traced launches. Each trace file's deform
    kernel events must equal the counters over its run; per file the 10
    device ops with the most time, the kernel count and the device's
    busy share (trace_summary). Then profile_model's MACs and parameters
    of configs a-e at their input sizes, on the CPU and on the card
    (equal). Returns the (forward, backward) launches of the CLIs."""
    from codenet_torch.cli import main as cli_main
    from codenet_torch.cli import test as cli_test
    from codenet_torch.models import create_model
    from codenet_torch.ops import deform_cuda as DC
    from codenet_torch.utils.profile import profile_model
    out, fail, launches = {"phase": "trace"}, [], [0, 0]
    exp = ROOT / "exp" / "ctdet" / "chip_smoke_trace"
    shutil.rmtree(exp, ignore_errors=True)
    trace_dir = exp / "debug" / "trace"
    n_val = len(data.dataset(data.opt(1), "val"))
    # one step an epoch: the 64 train frames make two batches of 32
    runs = [("main", cli_main.main, TRAIN_BATCH,
             ["--num_epochs", str(TRACE_STEPS), "--num_iters", "1",
              "--val_intervals", "-1", "--print_iter", "1"],
             (3 * TRACE_STEPS + 3 * n_val, 3 * TRACE_STEPS), 2),
            ("test_flip", cli_test.main, 1,
             ["--flip_test", "--load_model", str(exp / "model_last.pth")],
             (3 * n_val, 0), 1)]
    for name, fn, batch, args, want, files in runs:
        before = set(trace_dir.glob("*.pt.trace.json"))
        DC.LAUNCHES = DC.BWD_LAUNCHES = 0
        text, seconds = _cli_log(fn, data.args(
            batch, "--trace", "--exp_id", "chip_smoke_trace", *args))
        got = (DC.LAUNCHES, DC.BWD_LAUNCHES)
        launches = [a + b for a, b in zip(launches, got)]
        new = sorted(set(trace_dir.glob("*.pt.trace.json")) - before)
        summaries = [trace_summary(f) for f in new]
        traced = (sum(t["fwd_kernels"] for t in summaries),
                  sum(t["bwd_kernels"] for t in summaries))
        ap = _lines_with(text, "Mean AP")
        out[name] = {"seconds": seconds, "launches": list(got),
                     "traced": list(traced), "files": summaries,
                     "mean_ap_line": ap[-1] if ap else None}
        if (got != want or traced != got or len(new) != files or not ap
                or not all(t["kernels"] > 0 for t in summaries)):
            fail.append(name)

    opt = data.opt(1)
    configs = {"a": (RES, False, False), **AE_CONFIGS}
    out["profile_model"] = {}
    for name, (res, w2, maxpool) in configs.items():
        counts = []
        for dev in ("cpu", "cuda"):
            model = create_model(opt.arch, opt.heads, opt.head_conv, w2=w2,
                                 maxpool=maxpool, device=dev)
            log = io.StringIO()
            with contextlib.redirect_stdout(log):
                macs, params = profile_model(model, (1, res, res, 3))
            counts.append({"macs": macs, "params": params,
                           "line": log.getvalue().strip()})
            del model
        out["profile_model"][name] = {"res": res, "w2": w2,
                                      "maxpool": maxpool, "cpu": counts[0],
                                      "card": counts[1]}
        if counts[0] != counts[1] or not counts[0]["macs"] > 0:
            fail.append("profile_model " + name)
    out["failed"] = fail
    emit(out)
    if fail:
        raise SystemExit("trace check failed: {}".format(fail))
    return launches


def phase_dense_targets(data, pose, kitti, exdet):
    """Training on CenterNet's dense targets: config a FP32 with
    --mse_loss --dense_wh (MSRA heatmaps of std --hm_gauss, a dense box
    size map in place of wh), one step card vs CPU at batch 4 from
    conditioned_init from host batches and from --device_cache (STEP_TOL,
    as step_parity holds), then DENSE_TIMED_STEPS steps at batch 32 from
    each in turns, each loader timed apart; multi_pose at 512^2 with
    --mse_loss --dense_hp, POSE_DENSE_STEPS steps at batch 32; ddd and
    exdet with --mse_loss, one step each at DENSE_TASK_BATCH (their MSRA
    gaussians take the object's radius as std, and an object of radius 0
    draws a NaN centre, as in the JAX package: the loss must be finite
    exactly where the targets are). Returns the (forward, backward)
    launches of the training paths."""
    from codenet_torch.data.device_cache import ImageCache
    from codenet_torch.engine.trainer import Trainer
    out, fail, launches = {"phase": "dense_targets"}, [], [0, 0]
    flags = ("--mse_loss", "--dense_wh")
    state = conditioned_init(data.opt(TRAIN_BATCH))
    for name, extra in (("host", flags), ("cache",
                                          flags + ("--device_cache",))):
        parity, ok = step_parity(data, state, extra=extra)
        out["parity_" + name] = {"batch": 4, **parity, "tol": STEP_TOL}
        launches = [a + b for a, b in zip(launches,
                                          parity["launches_fwd_bwd"])]
        if not ok:
            fail.append("parity " + name)

    paths = {}
    for name, extra in (("host", flags), ("cache",
                                          flags + ("--device_cache",))):
        opt = data.opt(TRAIN_BATCH, *extra)
        ds = data.dataset(opt)
        stack = None
        if opt.device_cache:
            cache = ImageCache.build(ds)
            ds._image_cache_dims = cache.dims
            stack = cache.to_device("cuda")
        batches, out["loader_ms_per_batch_" + name] = loader_batches(
            ds, TRAIN_BATCH, DENSE_TIMED_STEPS, opt.num_workers, opt.seed)
        trainer = Trainer(opt, device="cuda")
        trainer.init()
        paths[name] = (trainer, batches, stack)
    out["steps_in_turns"] = timed_steps_in_turns(paths)

    def check(run, name, finite=True):
        if (np.all(np.isfinite(run["losses"])) != finite or any(
                st != [3, 3] for st in run["launches_per_step"])):
            fail.append(name)
        launches[0] += run["launches_fwd"]
        launches[1] += run["launches_bwd"]
    for name, run in out["steps_in_turns"].items():
        check(run, name)
    del paths

    popt = pose.opt(TRAIN_BATCH, "--mse_loss", "--dense_hp")
    batches, loader_ms = loader_batches(pose.dataset(popt), TRAIN_BATCH,
                                        POSE_DENSE_STEPS, popt.num_workers,
                                        popt.seed)
    trainer = Trainer(popt, device="cuda")
    trainer.init()
    run = timed_steps(trainer, batches)
    out["multi_pose"] = dict(run, res=COCO_RES, loader_ms_per_batch=loader_ms,
                             dense_hps=list(batches[0]["dense_hps"].shape))
    check(run, "multi_pose")
    del batches, trainer

    for name, task in (("ddd", kitti), ("exdet", exdet)):
        topt = task.opt(DENSE_TASK_BATCH, "--mse_loss")
        batches, loader_ms = loader_batches(
            task.dataset(topt), DENSE_TASK_BATCH, 1, topt.num_workers,
            topt.seed)
        finite = all(np.isfinite(v).all() for k, v in batches[0].items()
                     if k != "meta" and np.asarray(v).dtype.kind == "f")
        trainer = Trainer(topt, device="cuda")
        trainer.init()
        run = timed_steps(trainer, batches)
        out[name] = dict(run, loader_ms_per_batch=loader_ms,
                         targets_finite=bool(finite))
        check(run, name, finite)
        del batches, trainer
    out["failed"] = fail
    emit(out)
    if fail:
        raise SystemExit("dense_targets check failed: {}".format(fail))
    return launches


def phase_ladder_ops():
    """The deform-conv ladder (models/deform_modules.py: every rung, its
    predictors moved off their zero init) and the op inventory
    (InPlace-ABN, ROI-Align, deformable PS-ROI pooling), forward and the
    gradients of every input and parameter, card against CPU at a small
    f32 shape, each within LADDER_TOL of its max. None launches a deform
    kernel: the rungs are full convs on the plain general op, the ops
    plain PyTorch (XLA ops in the JAX package)."""
    from codenet_torch.models import deform_modules as DMOD
    from codenet_torch.ops import deform_cuda as DC
    from codenet_torch.ops.abn import inplace_abn
    from codenet_torch.ops.deform_pool import deform_psroi_pooling
    from codenet_torch.ops.roi_align import roi_align
    out, fail = {"phase": "ladder_ops", "tol": LADDER_TOL}, []
    r = np.random.RandomState(SEED + 15)
    gen = torch.Generator().manual_seed(SEED + 15)

    def card_vs_cpu(name, fn, ins, module=None):
        errs = {}
        res = []
        for dev in ("cuda", "cpu"):
            t = [torch.from_numpy(a).to(dev).requires_grad_() for a in ins]
            mod = module.to(dev) if module is not None else None
            if mod is not None:
                mod.zero_grad()
            y = fn(mod, *t) if mod is not None else fn(*t)
            w = torch.linspace(-1, 1, y.numel(), device=dev).reshape(y.shape)
            (y * w).sum().backward()
            grads = {"out": y.detach().cpu()}
            grads.update({"in{}".format(i): a.grad.cpu()
                          for i, a in enumerate(t)})
            if mod is not None:
                grads.update({k: p.grad.cpu()
                              for k, p in mod.named_parameters()})
            res.append(grads)
        for k, ref in res[1].items():
            scale = max(float(ref.abs().max()), 1e-12)
            errs[k] = float((res[0][k] - ref).abs().max()) / scale
        out[name] = {"shape": [list(a.shape) for a in ins],
                     "max_rel_err": max(errs.values())}
        if not max(errs.values()) <= LADDER_TOL:
            fail.append(name)

    before = (DC.LAUNCHES, DC.BWD_LAUNCHES)
    x = r.randn(2, 32, 32, 32).astype(np.float32)
    for cls in DMOD.LADDER:
        mod = cls(32, 24)
        mod.reset_parameters(gen)
        with torch.no_grad():
            for key, p in mod.named_parameters():
                if key.startswith("conv_"):
                    p.add_(torch.randn(p.shape, generator=gen) * 0.05)
        card_vs_cpu(cls.__name__, lambda m, t: m(t), [x], mod)
    a = r.randn(8, 32, 32, 64).astype(np.float32)
    card_vs_cpu("inplace_abn", lambda t: inplace_abn(
        t, torch.linspace(-1.5, 1.5, 64, device=t.device),
        torch.linspace(-0.5, 0.5, 64, device=t.device),
        t.detach().mean((0, 1, 2)), t.detach().var((0, 1, 2), False)), [a])
    data = r.randn(2, 32, 32, 49 * 2).astype(np.float32)
    rois = np.concatenate([r.randint(0, 2, (16, 1)),
                           r.uniform(-32, 400, (16, 2)),
                           r.uniform(0, 560, (16, 2))], 1).astype(np.float32)
    rois[:, 3:] = np.maximum(rois[:, 3:], rois[:, 1:3] + 8)
    card_vs_cpu("roi_align", lambda t: roi_align(
        t, torch.from_numpy(rois).to(t.device), 7, 7, 1.0 / 16, 0), [data])
    trans = (r.randn(16, 7, 7, 4) * 0.1).astype(np.float32)
    card_vs_cpu("deform_psroi_pooling", lambda t, tr: deform_psroi_pooling(
        t, torch.from_numpy(rois).to(t.device), tr, output_dim=2,
        pooled_size=7, group_size=7, spatial_scale=1.0 / 16), [data, trans])
    out["deform_launches"] = [DC.LAUNCHES - before[0],
                              DC.BWD_LAUNCHES - before[1]]
    if out["deform_launches"] != [0, 0]:
        fail.append("deform launches")
    out["failed"] = fail
    emit(out)
    if fail:
        raise SystemExit("ladder_ops check failed: {}".format(fail))


# -- the graphed engine, the fused heads, K-batch eval, native soft-NMS -----

GRAPH_STEPS = 6        # steps of each graphed and per-step epoch (batch 32)
GRAPH_EPOCH_STEPS = 8  # then a timed epoch of each through the DataLoader
GRAPH_TIMED_STEPS = 4  # more steps of each engine, in turns, each timed
GRAPH_TOL = STEP_TOL   # graphed vs per-step epochs: weights and loss meters
# graphed vs per-step epochs: relative L2 of the parameters' change over
# the epoch. Sound runs read 1.44-1.55e-2 in FP32 (host and cache
# batches: each run's deform backward sums with atomics in its own order)
# and 1.3e-6 to 2.5e-3 in QAT; a graph that skips Adam's update reads
# about 1 (PERF.md §5)
GRAPH_UPDATE_TOL = {"fp32": 1e-1, "cache": 1e-1, "qat": 1e-2}
FUSED_TOL = 1e-5       # fused vs per-head heads on the card (relative)
KBATCH = (8, 8)        # K batches of B images of the K-batch cached eval
MERGE_FRAMES = 4       # 5-scale --nms requests, native and numpy soft-NMS
GRAPH_TRACE_STEPS = 2  # graph replays traced by the profiler


def _rel_l2_state(a, b, keys):
    num = sum(float(((a[k].double() - b[k].double()) ** 2).sum())
              for k in keys)
    den = sum(float((b[k].double() ** 2).sum()) for k in keys)
    return (num / max(den, 1e-300)) ** 0.5


def _loader_stream(ds, opt):
    """The batches of a shuffled DataLoader over `ds` (its worker
    threads, its prefetch), one epoch after another: the same stream for
    every call."""
    from codenet_torch.data.loader import DataLoader
    loader = DataLoader(ds, TRAIN_BATCH, shuffle=True,
                        num_workers=opt.num_workers, seed=opt.seed)
    return itertools.chain.from_iterable(loader for _ in itertools.count())


def _epoch(trainer, engine, stream, steps):
    """`steps` train steps of Trainer.run_epoch from `stream`, through the
    graphed engine or the per-step path; (stats, seconds, launches)."""
    from codenet_torch.ops import deform_cuda as DC
    os.environ["CODENET_SCAN_EPOCH"] = "1" if engine == "graphed" else "0"
    before = (DC.LAUNCHES, DC.BWD_LAUNCHES)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    try:
        stats = trainer.run_epoch("train", 1, stream, num_iters=steps)
    finally:
        os.environ.pop("CODENET_SCAN_EPOCH", None)
    torch.cuda.synchronize()
    return (stats, time.perf_counter() - t0,
            [DC.LAUNCHES - before[0], DC.BWD_LAUNCHES - before[1]])


def _graph_epochs(data, state, name, qspec, extra, out, fail):
    """One epoch of GRAPH_STEPS steps of config a at TRAIN_BATCH through
    Trainer.run_epoch's graphed engine (each step a replay of the
    captured graph, the first GRAPH_WARMUP eager) and one through its
    per-step path, both fed by the DataLoader from `state`: weights,
    parameter updates and loss meters compared. Then an epoch of
    GRAPH_EPOCH_STEPS steps of each through the loader, timed on the
    host's clock (loading included, the graph already captured); then
    GRAPH_TIMED_STEPS more steps of each, in turns, timed with CUDA
    events (batch copy included); last, with the fp32 run, the
    profiler's deform kernel events over GRAPH_TRACE_STEPS replays
    against the launch counters. Returns the (forward, backward)
    launches."""
    from codenet_torch.data.device_cache import ImageCache
    from codenet_torch.engine import trainer as T
    from codenet_torch.ops import deform_cuda as DC
    opt = data.opt(TRAIN_BATCH, *extra)
    ds = data.dataset(opt)
    stack = None
    if opt.device_cache:
        cache = ImageCache.build(ds)
        ds._image_cache_dims = cache.dims
        stack = cache.to_device("cuda")
    timed_batches, _ = loader_batches(ds, TRAIN_BATCH, GRAPH_TIMED_STEPS,
                                      opt.num_workers, opt.seed + 1)
    runs, trainers, streams, launches = {}, {}, {}, [0, 0]
    for engine in ("graphed", "per_step"):
        trainer = T.Trainer(opt, qspec=qspec, device="cuda")
        trainer.model.load_state_dict(state, strict=qspec is None)
        trainer.init()
        trainer.image_cache = stack
        start = {k: v.clone() for k, v in trainer.model.state_dict().items()}
        streams[engine] = _loader_stream(ds, opt)
        stats, seconds, got = _epoch(trainer, engine, streams[engine],
                                     GRAPH_STEPS)
        launches = [a + b for a, b in zip(launches, got)]
        graphs = list(trainer._multi_steps.values())
        runs[engine] = {"epoch_s": seconds, "stats": stats,
                        "launches": got, "graphs": len(graphs),
                        "replayed_steps": sum(g.graph.replays
                                              for g in graphs)}
        trainers[engine] = (trainer, start)
    g, p = runs["graphed"], runs["per_step"]
    state_g = trainers["graphed"][0].model.state_dict()
    state_p = trainers["per_step"][0].model.state_dict()
    start = trainers["per_step"][1]
    params = [k for k, _ in trainers["per_step"][0].model.named_parameters()]
    res = {"steps": GRAPH_STEPS, "warmup_steps": T.GRAPH_WARMUP,
           "graphed": g, "per_step": p,
           "weights_rel_l2": _rel_l2_state(state_g, state_p, params),
           "updates_rel_l2": _rel_l2_state(
               {k: state_g[k] - start[k] for k in params},
               {k: state_p[k] - start[k] for k in params}, params),
           "meters_rel": {k: abs(g["stats"][k] - v) / max(abs(v), 1e-12)
                          for k, v in p["stats"].items()}}
    if qspec is not None:
        ranges = [k for k in state_p if k.endswith(("x_min", "x_max"))]
        res["ranges_rel_l2"] = _rel_l2_state(state_g, state_p, ranges)

    # an epoch of each engine through the loader, the graph captured
    for engine in ("graphed", "per_step"):
        _, seconds, got = _epoch(trainers[engine][0], engine,
                                 streams[engine], GRAPH_EPOCH_STEPS)
        launches = [a + b for a, b in zip(launches, got)]
        res[engine]["loader_epoch"] = {
            "steps": GRAPH_EPOCH_STEPS, "s": seconds,
            "ms_per_step": seconds * 1e3 / GRAPH_EPOCH_STEPS,
            "launches": got}
    res["loader_per_step_over_graphed"] = (
        res["per_step"]["loader_epoch"]["s"]
        / res["graphed"]["loader_epoch"]["s"])

    # timed steps in turns: the graphed engine's runner against the step
    sig = T.batch_signature(timed_batches[0], stack)
    run = trainers["graphed"][0]._multi_steps[sig]
    step = trainers["per_step"][0].train_step
    ms = {"graphed": [], "per_step": []}
    for batch in timed_batches:
        for engine in ms:
            torch.cuda.synchronize()
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            before = (DC.LAUNCHES, DC.BWD_LAUNCHES)
            a.record()
            if engine == "graphed":
                run(batch)
            else:
                dev = T.batch_to_device(batch, "cuda")
                if stack is not None:
                    dev["cache_images"] = stack
                step(dev)
            b.record()
            torch.cuda.synchronize()
            ms[engine].append(a.elapsed_time(b))
            launches[0] += DC.LAUNCHES - before[0]
            launches[1] += DC.BWD_LAUNCHES - before[1]
    for engine, times in ms.items():
        res[engine]["ms_per_step"] = times
        res[engine]["ms_per_step_median"] = float(np.median(times))
    res["per_step_over_graphed"] = (res["per_step"]["ms_per_step_median"]
                                    / res["graphed"]["ms_per_step_median"])

    if name == "fp32":
        trace = ROOT / "exp" / "chip_smoke" / "graphs_trace.json"
        trace.parent.mkdir(parents=True, exist_ok=True)
        acts = [torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]
        before = (DC.LAUNCHES, DC.BWD_LAUNCHES)
        with torch.profiler.profile(activities=acts) as prof:
            for batch in timed_batches[:GRAPH_TRACE_STEPS]:
                run(batch)
            torch.cuda.synchronize()
        counted = [DC.LAUNCHES - before[0], DC.BWD_LAUNCHES - before[1]]
        launches = [a + b for a, b in zip(launches, counted)]
        prof.export_chrome_trace(str(trace))
        summary = trace_summary(trace)
        res["trace"] = {"replays": GRAPH_TRACE_STEPS, "counted": counted,
                        "traced": [summary["fwd_kernels"],
                                   summary["bwd_kernels"]],
                        "kernels": summary["kernels"],
                        "busy_share": summary["busy_share"]}
        if counted != res["trace"]["traced"] or counted != [
                3 * GRAPH_TRACE_STEPS] * 2:
            fail.append(name + " trace")
    out[name] = res
    want = [3 * GRAPH_STEPS] * 2
    timed = [3 * GRAPH_EPOCH_STEPS] * 2
    if (g["launches"] != want or p["launches"] != want
            or g["loader_epoch"]["launches"] != timed
            or p["loader_epoch"]["launches"] != timed
            or g["replayed_steps"] != GRAPH_STEPS - T.GRAPH_WARMUP
            or p["replayed_steps"] != 0 or g["graphs"] != 1
            or not res["weights_rel_l2"] <= GRAPH_TOL
            or not res["updates_rel_l2"] <= GRAPH_UPDATE_TOL[name]
            or not max(res["meters_rel"].values()) <= GRAPH_TOL
            or set(g["stats"]) != set(p["stats"])):
        fail.append(name)
    return launches


def _heads_fused_vs_per_head(data, state, out, fail):
    """The fused heads against the per-head heads on the card: the served
    model's eval heads over one neck at TRAIN_BATCH (FUSED_TOL of each
    head's max), each form timed; one FP32 train step from `state` with
    fuse_heads True and False (loss and the heads' gradients at
    FUSED_TOL, every gradient at STEP_TOL: the deform backward sums with
    atomics), and the heads' train forward + backward over one neck
    timed each way."""
    from codenet_torch.engine.trainer import Trainer, batch_to_device
    from codenet_torch.models.fused_heads import (apply_fused_heads,
                                                  apply_fused_heads_train)
    from codenet_torch.models.layers import nhwc
    model = build_served_model()
    gen = torch.Generator().manual_seed(SEED + 16)
    x = torch.randn(TRAIN_BATCH, RES, RES, 3, generator=gen).cuda()
    res = {}
    with torch.no_grad():
        neck = model(x, return_neck=True)

        def per_head():
            return {n: nhwc(getattr(model, n)(neck)).float()
                    for n, _ in model.heads}
        ref, got = per_head(), apply_fused_heads(model, neck)
        res["eval_rel_err"] = {k: float((got[k] - ref[k]).abs().max())
                               / float(ref[k].abs().max()) for k in ref}
        res["eval_ms_fused"] = cuda_time_ms(
            lambda: apply_fused_heads(model, neck), 20)
        res["eval_ms_per_head"] = cuda_time_ms(per_head, 20)
    if not max(res["eval_rel_err"].values()) <= FUSED_TOL:
        fail.append("fused eval heads")

    opt = data.opt(TRAIN_BATCH)
    batch = loader_batches(data.dataset(opt), TRAIN_BATCH, 1,
                           opt.num_workers, opt.seed + 1)[0][0]
    steps = {}
    for fuse in (True, False):
        trainer = Trainer(opt, device="cuda", fuse_heads=fuse)
        trainer.model.load_state_dict(state)
        trainer.init()
        stats = trainer.train_step(batch_to_device(batch, "cuda"))
        steps[fuse] = (trainer.model, float(stats["loss"]))
    (fused, loss_f), (plain, loss_p) = steps[True], steps[False]
    err = grads_vs(fused, plain)
    heads = [n for n, _ in fused.named_parameters()
             if n.split(".")[0] in dict(fused.heads)]
    head_grads = _rel_l2_state(
        {n: p.grad for n, p in fused.named_parameters()},
        {n: p.grad for n, p in plain.named_parameters()}, heads)
    res["train"] = {"loss_fused": loss_f, "loss_per_head": loss_p,
                    "loss_rel": abs(loss_f - loss_p) / abs(loss_p),
                    "head_grad_rel_l2": head_grads,
                    "grad_rel_l2": err["grad_rel_l2"],
                    "grad_tensor_rel_median":
                        err["grad_tensor_rel_median"]}
    if not (res["train"]["loss_rel"] <= FUSED_TOL
            and head_grads <= FUSED_TOL
            and err["grad_rel_l2"] <= STEP_TOL):
        fail.append("fused train heads")

    fused.train()
    tneck = neck.detach().requires_grad_()

    def train_heads(fn):
        out = fn()
        sum(v.float().square().mean() for v in out.values()).backward()
    res["train_ms_fused"] = cuda_time_ms(lambda: train_heads(
        lambda: apply_fused_heads_train(fused, tneck)), 20)
    res["train_ms_per_head"] = cuda_time_ms(lambda: train_heads(
        lambda: {n: nhwc(getattr(fused, n)(tneck)).float()
                 for n, _ in fused.heads}), 20)
    out["heads"] = res
    return model


def _kbatch_eval(data, model, out, fail):
    """K-batch cached eval on the card: KBATCH's K batches of B rows of an
    image cache of the 64 train frames, one CUDA graph replayed
    (process_batches_cached) against the loop of process_batch_cached;
    the detections with score > 0 equal as sets per image (ROADMAP.md
    §3, Ties); ms per image each way. Returns the forward launches."""
    from codenet_torch.data.device_cache import ImageCache
    from codenet_torch.engine.detector import CtdetDetector
    from codenet_torch.ops import deform_cuda as DC
    k, b = KBATCH
    ds = data.dataset(data.opt(1), "train")
    cache = ImageCache.build(ds)
    stack = cache.to_device("cuda")
    det = CtdetDetector(data.opt(1, "--flip_test"),
                        state_dict=model.state_dict(), device="cuda")
    geo = [det.pre_process_geometry(int(h), int(w)) for h, w in cache.dims]
    rows = np.arange(k * b).reshape(k, b) % len(geo)
    wti = np.stack([[geo[i][0] for i in r] for r in rows])
    ti = np.stack([[geo[i][1] for i in r] for r in rows])

    def loop():
        return torch.stack([det.process_batch_cached(stack, rows[i], wti[i],
                                                     ti[i])
                            for i in range(k)])
    before = DC.LAUNCHES
    graph = det.process_batches_cached(stack, rows, wti, ti).cpu().numpy()
    ref = loop().cpu().numpy()
    captured = DC.LAUNCHES - before
    equal = 0
    for g_img, r_img in zip(graph.reshape(k * b, -1, 6),
                            ref.reshape(k * b, -1, 6)):
        equal += (set(map(tuple, g_img[g_img[:, 4] > 0]))
                  == set(map(tuple, r_img[r_img[:, 4] > 0])))
    before = DC.LAUNCHES
    ms_graph = cuda_time_ms(
        lambda: det.process_batches_cached(stack, rows, wti, ti), 5)
    ms_loop = cuda_time_ms(loop, 5)
    launches = captured + DC.LAUNCHES - before
    graphs = det._kbatch_graphs
    out["kbatch"] = {"k": k, "b": b, "images_equal": int(equal),
                     "images": k * b, "graphs": len(graphs),
                     "graph_launches": [g.launches
                                        for g, _, _ in graphs.values()],
                     "ms_per_image_graph": ms_graph / (k * b),
                     "ms_per_image_loop": ms_loop / (k * b)}
    if (equal != k * b or len(graphs) != 1
            or next(iter(graphs.values()))[0].launches != (3 * k, 0)):
        fail.append("kbatch")
    return launches


def _merge_native_vs_numpy(model, out, fail):
    """MERGE_FRAMES per-image flip-test requests at the five test scales
    with --nms, each answered twice in turns: soft-NMS native
    (csrc/nms.cpp, built first) and numpy (ops/nms.py::soft_nms_numpy);
    the merge stage's ms of each, and each request's detections held
    equal between the two (rows and boxes equal, scores within 1e-6: the
    gaussian decay's expf and numpy's float32 exp round a last place
    apart, tests/test_torch_nms.py). Returns the forward launches."""
    from codenet_torch import config as cfg
    from codenet_torch.engine import detector as DET
    from codenet_torch.ops import deform_cuda as DC
    from codenet_torch.ops import nms as NMS
    opt = cfg.update_dataset_info_and_set_heads(
        cfg.parse(["ctdet", "--dataset", "pascal", "--arch",
                   "shufflenetv2", "--input_res", str(RES), "--flip_test",
                   "--test_scales", TEST_SCALES, "--nms"]),
        cfg.DATASET_SPECS["pascal"])
    det = DET.CtdetDetector(opt, state_dict=model.state_dict(),
                            device="cuda")
    frames = synthetic_frames(MERGE_FRAMES)[0]
    t0 = time.perf_counter()
    NMS.soft_nms(np.zeros((1, 5), np.float32))  # builds csrc/nms.cpp
    build_s = time.perf_counter() - t0
    merge = {"native": [], "numpy": []}
    dets = {"native": [], "numpy": []}
    score_err, equal = 0.0, 0
    before = DC.LAUNCHES
    for f in frames:
        for name, fn in (("native", NMS.soft_nms),
                         ("numpy", NMS.soft_nms_numpy)):
            DET.soft_nms = fn
            try:
                ret = det.run(f)
            finally:
                DET.soft_nms = NMS.soft_nms
            merge[name].append(ret["merge"] * 1e3)
            dets[name].append(ret["results"])
        a, b = (d[-1] for d in (dets["native"], dets["numpy"]))
        same = set(a) == set(b) and all(
            a[j].shape == b[j].shape
            and np.array_equal(a[j][:, :4], b[j][:, :4]) for j in b)
        if same:
            equal += 1
            score_err = max([score_err] + [
                float(np.abs(a[j][:, 4] - b[j][:, 4]).max())
                for j in b if len(b[j])])
    dets = {k: [int(sum(len(v) for v in r.values())) for r in v]
            for k, v in dets.items()}
    out["merge"] = {"scales": TEST_SCALES, "requests": len(frames),
                    "native_build_s": build_s,
                    "requests_equal": equal, "score_max_abs_err": score_err,
                    "ms_native": merge["native"], "ms_numpy": merge["numpy"],
                    "ms_native_median": float(np.median(merge["native"])),
                    "ms_numpy_median": float(np.median(merge["numpy"])),
                    "dets_native": dets["native"],
                    "dets_numpy": dets["numpy"]}
    if (not all(dets["native"]) or equal != len(frames)
            or not score_err <= 1e-6):
        fail.append("merge")
    return DC.LAUNCHES - before


def phase_graphs(data):
    """The JAX package's default engine on the card, config a at 256^2,
    batch 32, from conditioned_init: graphed against per-step epochs in
    FP32, QAT and --device_cache (_graph_epochs); the fused heads against
    the per-head ones (_heads_fused_vs_per_head); K-batch cached eval as
    one graph against the per-batch loop (_kbatch_eval); the 5-scale
    merge with the native and the numpy soft-NMS (_merge_native_vs_numpy).
    Returns the (forward, backward) launches."""
    from codenet_torch.models import create_model
    from codenet_torch.models.layers import QuantSpec
    out, fail = {"phase": "graphs", "tol": GRAPH_TOL,
                 "fused_tol": FUSED_TOL}, []
    opt = data.opt(TRAIN_BATCH)
    state = conditioned_init(opt)
    qspec = QuantSpec()
    qat = create_model(opt.arch, opt.heads, opt.head_conv, qspec=qspec,
                       device="cpu")
    qat.load_state_dict(state, strict=False)
    launches = [0, 0]
    for name, q, st, extra in (("fp32", None, state, ()),
                               ("qat", qspec, qat.state_dict(), ()),
                               ("cache", None, state, ("--device_cache",))):
        got = _graph_epochs(data, st, name, q, extra, out, fail)
        launches = [a + b for a, b in zip(launches, got)]
    model = _heads_fused_vs_per_head(data, state, out, fail)
    launches[0] += _kbatch_eval(data, model, out, fail)
    launches[0] += _merge_native_vs_numpy(model, out, fail)
    out["launches"] = launches
    out["failed"] = fail
    emit(out)
    if fail:
        raise SystemExit("graphs check failed: {}".format(fail))
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


PHASE_SECONDS = {}


def timed(name, fn, *args):
    """fn(*args), its wall seconds kept in PHASE_SECONDS[name]."""
    t0 = time.perf_counter()
    try:
        return fn(*args)
    finally:
        PHASE_SECONDS[name] = time.perf_counter() - t0


# the phases `--phases` may pick (those that need no earlier phase's
# results)
STANDALONE = ("trace", "dense_targets", "ladder_ops", "graphs", "ddp",
              "spatial")


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--out", default="",
                        help="also write every printed line to this file")
    parser.add_argument("--phases", default="",
                        help="run only these of {} after the build "
                        "(comma-separated; no kernels or ok line)".format(
                            ", ".join(STANDALONE)))
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        sys.exit("chip_smoke.py needs a CUDA card; none is visible")
    sys.path.insert(0, str(ROOT))
    import codenet_torch  # noqa: F401  (fails outside a checkout)

    t0 = time.perf_counter()
    smi = phase_env()
    bw, flops = card_peaks(torch.cuda.get_device_name(0))
    timed("build", phase_build)
    data = SmokeData()
    pose_data, kitti_data = CocoSmokeData("multi_pose"), KittiSmokeData()
    exdet_data = CocoSmokeData("exdet")
    only = [p for p in args.phases.split(",") if p]
    if only:
        unknown = set(only) - set(STANDALONE)
        if unknown:
            sys.exit("unknown --phases {}".format(sorted(unknown)))
        run = {"trace": lambda: phase_trace(data),
               "dense_targets": lambda: phase_dense_targets(
                   data, pose_data, kitti_data, exdet_data),
               "ladder_ops": phase_ladder_ops,
               "graphs": lambda: phase_graphs(data),
               "ddp": lambda: phase_ddp(data),
               "spatial": lambda: phase_spatial(data)}
        for name in only:
            timed(name, run[name])
        emit({"phase": "done", "seconds": time.perf_counter() - t0,
              "phase_seconds": PHASE_SECONDS, "card": smi})
        write_out(args.out)
        return
    timed("host_io", phase_host_io)
    rows = timed("kernels", phase_kernels, bw, flops)
    bwd_rows = timed("kernel_bwd", phase_kernel_bwd, bw, flops)
    keep_res_rows, keep_res_requests = timed(
        "kernel_keep_res", phase_kernel_keep_res, bw, flops)
    model = build_served_model()
    timed("model", phase_model, model)
    serve_launches = timed("detector", phase_detector, model)
    trace = timed("trace", phase_trace, data)
    dense = timed("dense_targets", phase_dense_targets, data, pose_data,
                  kitti_data, exdet_data)
    timed("ladder_ops", phase_ladder_ops)
    graphs = timed("graphs", phase_graphs, data)
    fp32, batches, train_run = timed("train", phase_train, data)
    qat_run, qat_eval_launches, qat_model = timed(
        "qat", phase_qat, data, fp32, batches)
    cli_bf16 = timed("cli", phase_cli, data)
    int8_launches, int8_cli_launches, int8_bf16 = timed(
        "int8", phase_int8, data, qat_model, bw, flops)
    cache_fwd, cache_bwd = timed("devcache", phase_devcache, data,
                                 train_run, batches)
    ddp = timed("ddp", phase_ddp, data)
    spatial = timed("spatial", phase_spatial, data)
    eval_paths_launches = timed("eval_paths", phase_eval_paths, data, model)
    multiscale_launches = timed("multiscale", phase_multiscale, model,
                                synthetic_frames(8)[0])
    bf16_launches, _ = timed("bf16", phase_bf16, model, data)
    bf16_train, _ = timed("bf16_train", phase_bf16_train, data, batches)
    backbone = timed("deform_backbone", phase_deform_backbone, data)
    coco = timed("coco_ctdet", phase_coco_ctdet, CocoSmokeData("ctdet"))
    pose = timed("multi_pose", phase_multi_pose, pose_data)
    ddd = timed("ddd", phase_ddd, kitti_data, rows, bwd_rows)
    exdet = timed("exdet", phase_exdet, exdet_data)
    int8_tasks = timed("int8_tasks", phase_int8_tasks)
    configs = timed("configs_ae", phase_configs_ae)
    timed("backbones", phase_backbones, CocoSmokeData("ctdet"))
    synth = timed("synthreg", phase_synthreg)

    pallas = next(ROOT.glob("*/ops/deform_pallas.py"))
    lines = pallas.read_text().splitlines()

    def replaces(fn):
        line = next(i + 1 for i, ln in enumerate(lines)
                    if ln.startswith("def {}(".format(fn)))
        return "{}:{}".format(pallas.relative_to(ROOT), line)

    emit({"phase": "done", "seconds": time.perf_counter() - t0,
          "phase_seconds": PHASE_SECONDS, "card": smi})
    emit(smi)
    fwd_entry = kernel_line_entry(
        "codesign_deform_fwd", "codenet_torch/csrc/deform_fwd.cu",
        replaces("_fwd_kernel"),
        serve_launches + train_run["launches_fwd"]
        + qat_run["launches_fwd"] + qat_eval_launches + int8_launches
        + int8_cli_launches + cache_fwd + eval_paths_launches
        + multiscale_launches + bf16_launches + bf16_train[0]
        + backbone[0] + cli_bf16[0] + coco[0] + pose[0] + ddd[0]
        + exdet[0] + int8_tasks + configs[0] + synth[0] + ddp[0]
        + spatial[0] + trace[0] + dense[0] + graphs[0],
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
    # and of one served forward of the 2x network at 512^2 (configs d and
    # e; batch 2, f32)
    fwd_entry.update(path_ms(rows, "served_forward_w2_512", 2, "float32",
                             shapes=W2_SHAPES))
    # backward: one train step's three calls (batch 32, f32); launches
    # over the FP32, QAT, image-cache, data-parallel (every rank's, counted
    # in its process), bf16, deform-backbone, multi_pose, ddd and exdet
    # training paths and the CLIs that train
    bwd_entry = kernel_line_entry(
        "codesign_deform_bwd", "codenet_torch/csrc/deform_bwd.cu",
        replaces("_bwd_kernel"),
        train_run["launches_bwd"] + qat_run["launches_bwd"] + cache_bwd
        + bf16_train[1] + backbone[1] + cli_bf16[1] + coco[1] + pose[1]
        + ddd[1] + exdet[1] + configs[1] + synth[1] + ddp[1] + spatial[1]
        + trace[1] + dense[1] + graphs[1], bwd_rows,
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
    # and of one train step of the 2x network at 512^2 (configs d and e;
    # batch 32, f32)
    bwd_entry.update(path_ms(bwd_rows, "train_step_w2_512", TRAIN_BATCH,
                             "float32", shapes=W2_SHAPES))
    emit({"kernels": [
        # forward: one served forward (flip-test batch 2, f32); launches
        # over the serving, training, QAT, fake-quant eval, int8 eval,
        # image-cache training, data-parallel (every rank's), batched
        # eval, multi-scale, bf16, deform-backbone, COCO, multi_pose, ddd
        # and exdet paths and CLIs
        fwd_entry, bwd_entry]})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    write_out(args.out)


def write_out(path):
    """Every printed line into `path` (--out), if given."""
    if path:
        Path(path).parent.mkdir(parents=True, exist_ok=True)
        Path(path).write_text("\n".join(_lines) + "\n")


if __name__ == "__main__":
    main()
