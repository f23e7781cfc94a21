"""Smoke test of the PyTorch port on one CUDA card.

    python3 chip_smoke.py [--out FILE]

Builds the co-designed deform conv kernels (codenet_torch/csrc/
deform_fwd.cu and deform_bwd.cu, one nvcc each, in parallel) and holds each
against its plain PyTorch version at the shapes the model gives it (the
forward at batches 2, 32, 64 and 128) and at ragged ones, timing both.
Then it drives the port's paths at full width (ctdet ShuffleNetV2-DCN 1x,
256^2):

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
  (tools_torch/export_w4a8.py).

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
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
SEED = 0
# (H, W, C) of the three deconv-stage deform calls at 256^2 input, 1x
MODEL_SHAPES = [(8, 8, 1024), (16, 16, 256), (32, 32, 128)]
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
TOL = {torch.float32: 1e-4, torch.bfloat16: 3e-2}
# card vs CPU on one train / QAT step: loss, and gradients (relative L2
# over all parameters; the median tensor and each deform-block tensor
# relative to its max)
STEP_TOL = 5e-3
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
    from codenet_torch.ops import deform_cuda as DC
    for name, info in DC.build().items():
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


def phase_kernels(bw, flops):
    """Forward kernel vs its plain version on the card at every shape,
    batch, dtype; each row with its launch plan (deform_cuda.fwd_plan)."""
    from codenet_torch.ops import deform_cuda as DC
    gen = torch.Generator().manual_seed(SEED)
    rows = []
    for shape in BWD_SHAPES:
        for n in BATCHES if shape in MODEL_SHAPES else RAGGED_BATCHES:
            for dtype in (torch.float32, torch.bfloat16):
                x, s, wt = _case(shape, n, dtype, gen)
                before = DC.LAUNCHES
                out = DC.codesign_deform_conv_fast(x, s, wt)
                torch.cuda.synchronize()
                launched = DC.LAUNCHES - before
                ref = DC.codesign_deform_conv_plain(x, s, wt)
                err = float((out.float() - ref.float()).abs().max())
                ms = graph_time_ms(
                    lambda: DC.codesign_deform_conv_fast(x, s, wt), 200)
                call_ms = cuda_time_ms(
                    lambda: DC.codesign_deform_conv_fast(x, s, wt), 200)
                plain_ms = graph_time_ms(
                    lambda: DC.codesign_deform_conv_plain(x, s, wt), 10)
                elems = x.numel()
                nbytes = 2 * elems * x.element_size() + s.numel() * 4 \
                    + 9 * shape[2] * 4
                t_bytes = nbytes / bw * 1e3
                t_ops = elems * FLOPS_PER_OUT / flops * 1e3
                plan = DC.fwd_plan(n, *shape, dtype)
                row = {"phase": "kernel", "shape": list(shape), "n": n,
                       "dtype": str(dtype).split(".")[-1],
                       **{k: plan[k] for k in ("rows", "cb", "vec",
                                               "threads", "smem_bytes",
                                               "blocks")},
                       "max_abs_err": err, "tol": TOL[dtype],
                       "launches": launched, "ms": ms, "call_ms": call_ms,
                       "plain_ms": plain_ms,
                       "bound_us": max(t_bytes, t_ops) * 1e3,
                       "bound_by": "bytes" if t_bytes >= t_ops
                       else "operations",
                       "model_shape": shape in MODEL_SHAPES}
                emit(row)
                rows.append(row)
                if launched != 1 or not err <= TOL[dtype]:
                    raise SystemExit("kernel check failed: {}".format(row))
    return rows


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
    """Backward kernel vs the plain backward at every shape, batch, dtype:
    error of dx, ds and dw relative to each output's max; each row with
    its launch plan (deform_cuda.bwd_plan)."""
    from codenet_torch.ops import deform_cuda as DC
    gen = torch.Generator().manual_seed(SEED + 2)
    rows = []
    for shape in BWD_SHAPES:
        for n in BWD_BATCHES:
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
                       "model_shape": shape in MODEL_SHAPES}
                emit(row)
                rows.append(row)
                worst = max(errs[k + "_rel"] for k in ("dx", "ds", "dw"))
                if launched != 1 or not worst <= TOL[dtype] \
                        or ds_at_bounds != 0.0:
                    raise SystemExit("kernel_bwd check failed: {}".format(
                        row))
    return rows


@torch.no_grad()
def build_served_model(device="cuda"):
    """Full-width PoseShuffleNetV2 1x on `device`, random but not
    degenerate: conv_scale redrawn (s fractional, partly off the map), BN
    running stats set from a random batch, each channel's variance at
    least twice its layer's mean. Without that floor near-dead channels
    are normalised to unit variance and the random network amplifies f32
    rounding until the card's and the CPU's heads differ by ~1e-3 of
    their range; with it they agree to ~1e-6."""
    from codenet_torch.models import create_model
    gen = torch.Generator().manual_seed(SEED)
    model = create_model("shufflenetv2", {"hm": 20, "wh": 2, "reg": 2}, 64,
                         device=device, generator=gen)
    for i in range(3):
        cs = model.deconv_layers[4 * i].conv_scale
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
    model(torch.randn(8, 256, 256, 3, generator=gen).to(device))
    for m in bns:
        m.momentum = 0.1
        m.running_var.clamp_(min=2.0 * float(m.running_var.mean()))
        m.weight.mul_(torch.rand(m.weight.shape, generator=gen).to(device)
                      + 0.5)
        m.bias.add_(torch.randn(m.bias.shape, generator=gen).to(device)
                    * 0.1)
    return model.eval()


@torch.no_grad()
def phase_model(model):
    """256^2 batch-2 forward on the card (kernel) vs on the CPU (plain)."""
    from codenet_torch.ops import deform_cuda as DC
    gen = torch.Generator().manual_seed(SEED + 1)
    images = torch.randn(2, 256, 256, 3, generator=gen)
    cpu_model = copy.deepcopy(model).cpu()
    before = DC.LAUNCHES
    out = model(images.cuda())
    torch.cuda.synchronize()
    launched = DC.LAUNCHES - before
    ref = cpu_model(images)
    heads = {}
    ok = launched == 3
    for name, r in ref.items():
        o = out[name].cpu()
        scale = float(r.abs().max())
        err = float((o - r).abs().max())
        heads[name] = {"shape": list(o.shape), "max_abs_err": err,
                       "max_rel_err": err / scale, "finite": bool(
                           torch.isfinite(o).all())}
        ok = ok and heads[name]["finite"] and err <= 1e-3 * scale
    emit({"phase": "model", "launches": launched, "heads": heads,
          "tol_rel": 1e-3})
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


class SmokeData:
    """A synthetic VOC set for the training phases: `n_train` + `n_val`
    frames (synthetic_frames) held in memory, their annotations written
    under exp/ (the layout data/datasets.py::PascalVOC reads), and every
    dataset's `load_image` overridden to return the in-memory frames."""

    def __init__(self, n_train=64, n_val=8):
        from codenet_torch.data.datasets import BaseDataset
        frames, gt = synthetic_frames(n_train + n_val)
        self.frames = {img["id"]: f for img, f in zip(gt["images"], frames)}
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
        frames_by_id = self.frames
        BaseDataset.load_image = \
            lambda ds, index: frames_by_id[ds.images[index]]

    def args(self, batch, *extra):
        return ["ctdet", "--dataset", "pascal", "--arch", "shufflenetv2",
                "--input_res", "256", "--batch_size", str(batch),
                "--num_workers", "8", "--data_dir", str(self.data_dir),
                *extra]

    def opt(self, batch, *extra):
        from codenet_torch import config as cfg
        return cfg.update_dataset_info_and_set_heads(
            cfg.parse(self.args(batch, *extra)), cfg.DATASET_SPECS["pascal"])

    def dataset(self, opt, split="train"):
        from codenet_torch.data.datasets import get_dataset
        return get_dataset("pascal", "ctdet")(opt, split)


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


def conditioned_init(opt):
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
                         generator=torch.Generator().manual_seed(opt.seed))
    keep = {head + ".4" for head in opt.heads}
    with torch.no_grad():
        for name, m in model.named_modules():
            if isinstance(m, torch.nn.BatchNorm2d) and name not in keep:
                m.bias.add_(BN_SHIFT)
    return model.state_dict()


def step_parity(data, state_dict, qspec=None):
    """One train step at batch 4 on the card and on the CPU from the same
    weights and batch: the loss, the gradients over all parameters, the
    median tensor and each deform-block tensor (grads_vs), each held at
    STEP_TOL; the step's kernel launches."""
    from codenet_torch.data.loader import DataLoader
    from codenet_torch.engine.trainer import Trainer, batch_to_device
    from codenet_torch.ops import deform_cuda as DC
    opt = data.opt(4)
    batch = next(iter(DataLoader(data.dataset(opt), 4, shuffle=True,
                                 num_workers=4, seed=1)))
    card = Trainer(opt, qspec=qspec, device="cuda")
    cpu = Trainer(opt, qspec=qspec, device="cpu")
    card.model.load_state_dict(state_dict)
    cpu.model.load_state_dict(state_dict)
    card.init()
    cpu.init()
    DC.LAUNCHES = DC.BWD_LAUNCHES = 0
    got = card.train_step(batch_to_device(batch, "cuda"))
    torch.cuda.synchronize()
    launches = (DC.LAUNCHES, DC.BWD_LAUNCHES)
    ref = cpu.train_step(batch_to_device(batch, "cpu"))
    err = grads_vs(card.model, cpu.model)
    out = {"loss_card": float(got["loss"]), "loss_cpu": float(ref["loss"]),
           "loss_rel": abs(float(got["loss"]) - float(ref["loss"]))
           / abs(float(ref["loss"])),
           "launches_fwd_bwd": list(launches), **err}
    ok = (launches == (3, 3) and out["loss_rel"] <= STEP_TOL
          and err["grad_rel_l2"] <= STEP_TOL
          and err["grad_tensor_rel_median"] <= STEP_TOL
          and len(err["deform_tensor_rel"]) == 12
          and max(err["deform_tensor_rel"].values()) <= STEP_TOL)
    return out, ok


def timed_steps(trainer, batches):
    """Train steps on the card, each timed with CUDA events; per-step
    deform launches and losses."""
    from codenet_torch.engine.trainer import batch_to_device
    from codenet_torch.ops import deform_cuda as DC
    DC.LAUNCHES = DC.BWD_LAUNCHES = 0  # the counts are this path's own
    ms, losses, per_step = [], [], []
    for batch in batches:
        dev = batch_to_device(batch, "cuda")
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        before = (DC.LAUNCHES, DC.BWD_LAUNCHES)
        start.record()
        stats = trainer.train_step(dev)
        end.record()
        torch.cuda.synchronize()
        ms.append(start.elapsed_time(end))
        losses.append(float(stats["loss"]))
        per_step.append([DC.LAUNCHES - before[0],
                         DC.BWD_LAUNCHES - before[1]])
    steady = float(np.median(ms[1:]))
    return {"steps": len(batches), "batch": TRAIN_BATCH, "ms_per_step": ms,
            "ms_per_step_steady_median": steady,
            "img_per_s": TRAIN_BATCH / steady * 1e3, "losses": losses,
            "launches_fwd": DC.LAUNCHES, "launches_bwd": DC.BWD_LAUNCHES,
            "launches_per_step": per_step}


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
    emit({"phase": "train", **run, "loader_ms_per_batch": loader_ms,
          "loader_workers": opt.num_workers})
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
    detection eval of the val frames."""
    from codenet_torch.cli import main as cli_main
    from codenet_torch.cli import quant_main
    from codenet_torch.ops import deform_cuda as DC
    common = ["--num_epochs", "1", "--num_iters", "2", "--lr_step", "1",
              "--val_intervals", "-1", "--print_iter", "1"]
    out = {"phase": "cli"}
    for name, fn, extra in (
            ("main", cli_main.main, ["--exp_id", "chip_smoke_fp32"]),
            ("quant_main", quant_main.main,
             ["--exp_id", "chip_smoke_qat", "--load_model",
              str(ROOT / "exp" / "ctdet" / "chip_smoke_fp32"
                  / "model_last.pth")])):
        DC.LAUNCHES = DC.BWD_LAUNCHES = 0
        log = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(log):
            fn(data.args(TRAIN_BATCH, *common, *extra))
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
        if (len(losses) != 2 or not np.all(np.isfinite(losses)) or not ap
                or DC.BWD_LAUNCHES != 6):
            emit(out)
            raise SystemExit("cli {} check failed".format(name))
    emit(out)


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
    model = build_served_model()
    phase_model(model)
    serve_launches = phase_detector(model)
    data = SmokeData()
    fp32, batches, train_run = phase_train(data)
    qat_run, qat_eval_launches, qat_model = phase_qat(data, fp32, batches)
    phase_cli(data)
    int8_launches, int8_cli_launches, int8_bf16 = phase_int8(
        data, qat_model, bw, flops)

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
        + int8_cli_launches, rows,
        lambda r: r["model_shape"] and r["n"] == 2
        and r["dtype"] == "float32")
    # and the three calls of one train forward (batch 32, f32), and of one
    # int8 served forward (batch 2, bf16, the weight cast included)
    fwd_entry["ms_train_forward"] = sum(
        r["ms"] for r in rows if r["model_shape"]
        and r["n"] == TRAIN_BATCH and r["dtype"] == "float32")
    fwd_entry["ms_int8_forward_bf16"] = int8_bf16["ms_int8_forward_bf16"]
    fwd_entry["bound_ms_int8_forward_bf16"] = \
        int8_bf16["bound_ms_int8_forward_bf16"]
    emit({"kernels": [
        # forward: one served forward (flip-test batch 2, f32); launches
        # over the serving, training, QAT, fake-quant eval and int8 eval
        # paths
        fwd_entry,
        # backward: one train step's three calls (batch 32, f32); launches
        # over the FP32 and QAT training paths
        kernel_line_entry(
            "codesign_deform_bwd", "codenet_torch/csrc/deform_bwd.cu",
            replaces("_bwd_kernel"),
            train_run["launches_bwd"] + qat_run["launches_bwd"], bwd_rows,
            lambda r: r["model_shape"] and r["n"] == TRAIN_BATCH
            and r["dtype"] == "float32")]})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text("\n".join(_lines) + "\n")


if __name__ == "__main__":
    main()
