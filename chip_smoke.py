"""Smoke test of the PyTorch port on one CUDA card.

    python3 chip_smoke.py [--out FILE]

Builds the co-designed deform conv kernel (codenet_torch/csrc/deform_fwd.cu)
with nvcc, holds it against its plain PyTorch version at the shapes the
served model gives it and at ragged ones, times both, then serves the
flagship ctdet ShuffleNetV2-DCN 1x at 256^2 with flip-test through
CtdetDetector: per-image requests and a batch-32 request, scored with the
port's VOC evaluator. Every phase prints one JSON line; a phase that fails
ends the script with a non-zero exit. The last two lines are the kernel
table ({"kernels": [...]}) and {"ok": true, "device": {...}}.

Weights are random (seeded): BN running stats are set from a random batch
and the deform scale predictors are redrawn, so that s is fractional and
partly outside the maps. TF32 is off throughout: the parity phases compare
FP32 against FP32.
"""

from __future__ import annotations

import argparse
import copy
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
BATCHES = [2, 128]
TOL = {torch.float32: 1e-4, torch.bfloat16: 3e-2}
# memory rate (B/s) and fp32 CUDA-core peak (FLOP/s) by card name
# (NVIDIA data sheets); the first match wins, SXM is the default
CARD_PEAKS = [("H200", 4.8e12, 67e12), ("H100 NVL", 3.9e12, 60e12),
              ("PCIe", 2.0e12, 51e12), ("H100", 3.35e12, 67e12)]
FLOPS_PER_OUT = 90  # 9 taps x (4 corner mul-adds + 1 tap-weight mul-add)

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
    info = DC.build()
    ptxas = [ln.strip() for ln in info["log"].splitlines()
             if "registers" in ln or "spill" in ln]
    emit({"phase": "build", "so": str(Path(info["path"]).relative_to(ROOT)),
          "nvcc_s": round(info["seconds"], 3), "cached": info["cached"],
          "ptxas": ptxas})


def _case(shape, n, dtype, gen):
    h, w, c = shape
    x = torch.randn(n, h, w, c, generator=gen).to("cuda", dtype)
    s = (torch.rand(n, h, w, 1, generator=gen) * 19.0 - 9.0).cuda()
    wt = (torch.randn(3, 3, 1, c, generator=gen) * 0.2).to("cuda", dtype)
    return x, s, wt


def phase_kernels(bw, flops):
    """Kernel vs plain version on the card at every shape, batch, dtype."""
    from codenet_torch.ops import deform_cuda as DC
    gen = torch.Generator().manual_seed(SEED)
    rows = []
    for shape in MODEL_SHAPES + RAGGED_SHAPES:
        for n in BATCHES:
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
                row = {"phase": "kernel", "shape": list(shape), "n": n,
                       "dtype": str(dtype).split(".")[-1],
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
    model = build_served_model()
    phase_model(model)
    launches = phase_detector(model)

    served = [r for r in rows if r["model_shape"] and r["n"] == 2
              and r["dtype"] == "float32"]
    pallas = next(ROOT.glob("*/ops/deform_pallas.py"))
    line = next(i + 1 for i, ln in enumerate(
        pallas.read_text().splitlines()) if ln.startswith("def _fwd_kernel"))
    emit({"phase": "done", "seconds": time.perf_counter() - t0,
          "card": smi})
    emit({"kernels": [{
        "name": "codesign_deform_fwd",
        "route": "cuda",
        "source": "codenet_torch/csrc/deform_fwd.cu",
        "replaces": "{}:{}".format(pallas.relative_to(ROOT), line),
        "launches": launches,
        "max_abs_err": max(r["max_abs_err"] for r in rows),
        # one served forward (flip-test batch 2, f32): the three deconv
        # launches summed
        "ms": sum(r["ms"] for r in served),
        "plain_ms": sum(r["plain_ms"] for r in served),
        "bound_ms": sum(r["bound_us"] for r in served) / 1e3,
        "bound_by": "bytes" if all(r["bound_by"] == "bytes"
                                   for r in served) else "operations",
        "library_ms": None}]})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text("\n".join(_lines) + "\n")


if __name__ == "__main__":
    main()
