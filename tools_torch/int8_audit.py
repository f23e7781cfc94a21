#!/usr/bin/env python
"""Layer-by-layer fake-quant vs real-int8 numerics audit of the port.

The port's copy of the JAX package's tools_tpu/int8_audit.py. It runs
the flagship ShuffleNetV2-DCN once under each of three quantization
semantics and diffs every module's output:

  qat      unclamped asymmetric fake-quant (the reference's training
           numerics: out-of-range activations pass through)
  clamped  fake-quant with the int8 window clamp (--act_clamp; the
           deployed ranges, float compute)
  int8     real int8 storage, integer convs and fused requantization
           (ops/quant.py::int8_conv, the deployed path)

`clamped-vs-qat` is the range clamp alone (large where the EMA ranges
undershoot the activations); `int8-vs-clamped` is the integer lowering
alone (one rounding per layer; it should stay at the requantization
noise floor). The first layer whose int8-vs-clamped divergence exceeds
--lowering_tol is where a lowering bug starts. --w2 and --maxpool build
the 2x network and the pooled stem (configs b-e), where a lowering bug
in the 2153-channel deconv0 or the int8 pool would first show.

Outputs are taken with forward hooks: every module called as a module
(activation quantizers, backbone nodes and stages, deform blocks,
heads, the model), a QTensor output dequantized, 4-D maps reported
channel last; a module called k > 1 times in a forward (a stage's
shared quantizer) gives rows name/0 .. name/k-1. The stem pool and the
upsamplers are left out: in int8 they move raw levels.

Usage:
  python tools_torch/int8_audit.py                       # random weights
  python tools_torch/int8_audit.py --ckpt exp/ctdet/x/model_last.pth
  python tools_torch/int8_audit.py --json audit.json --input_res 128 \\
      [--w2] [--maxpool] [--gpus -1]
A --ckpt may be a port .pth or a JAX package .ckpt. Runs on the card
unless --gpus -1.
"""

import argparse
import json
import os
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

HEADS = {"hm": 20, "wh": 2, "reg": 2}


def _host(v):
    """A module output -> numpy, channel last for 4-D maps (QTensor
    dequantized)."""
    from codenet_torch.ops.quant import QTensor
    if isinstance(v, QTensor):
        v = v.dequant()
    a = v.detach().float().cpu().numpy()
    return np.transpose(a, (0, 2, 3, 1)) if a.ndim == 4 else a


def capture(model, x):
    """{row name: numpy output} of one forward of `model` on x (NHWC)."""
    import torch
    from codenet_torch.ops.quant import QTensor
    calls = {}

    def hook(name):
        def fn(module, args, out):
            calls.setdefault(name, []).append(out)
        return fn
    skip = (torch.nn.MaxPool2d, torch.nn.Upsample)
    handles = [m.register_forward_hook(hook(name))
               for name, m in model.named_modules()
               if not isinstance(m, skip)]
    try:
        with torch.no_grad():
            model(x)
    finally:
        for h in handles:
            h.remove()
    out = {}
    for name, outs in calls.items():
        for i, o in enumerate(outs):
            key = name if len(outs) == 1 else "{}/{}".format(name, i)
            if isinstance(o, dict):
                for k, v in o.items():
                    out["{}/{}".format(key, k) if key else k] = _host(v)
            elif isinstance(o, (tuple, list)) and not isinstance(o, QTensor):
                for j, v in enumerate(o):
                    out["{}/{}".format(key, j)] = _host(v)
            else:
                out[key] = _host(o)
    return out


def run_audit(ckpt=None, input_res=128, seed=0, w_bit=4, a_bit=8,
              percentile=False, w2=False, maxpool=False, device="cpu"):
    """The per-layer rows {layer, shape, clamped_vs_qat, int8_vs_clamped}
    of one input (numpy RandomState(seed).rand, NHWC, as the JAX tool
    draws it), each difference relative to the clamped output's max."""
    import torch
    from codenet_torch.engine import checkpoint
    from codenet_torch.models import create_model
    from codenet_torch.models.layers import QuantSpec

    rng = np.random.RandomState(seed)
    x = torch.from_numpy(rng.rand(1, input_res, input_res, 3).astype(
        np.float32)).to(device)

    def build(spec):
        return create_model("shufflenetv2", HEADS, 64, w2=w2,
                            maxpool=maxpool, qspec=spec, device=device,
                            generator=torch.Generator().manual_seed(seed))

    specs = {
        "qat": QuantSpec(w_bit=w_bit, a_bit=a_bit, wt_percentile=percentile),
        "clamped": QuantSpec(w_bit=w_bit, a_bit=a_bit,
                             wt_percentile=percentile, act_clamp=True),
        "int8": QuantSpec(w_bit=w_bit, a_bit=a_bit,
                          wt_percentile=percentile, act_clamp=True,
                          int8_infer=True),
    }

    # one set of weights for all three (the modes share one state_dict)
    model = build(specs["qat"])
    if ckpt:
        checkpoint.load_model(ckpt, model)
    else:
        # activation ranges from a few range-updating forwards, so that
        # the quantized paths see realistic windows
        with torch.no_grad():
            for _ in range(4):
                calib = torch.from_numpy(rng.rand(
                    1, input_res, input_res, 3).astype(np.float32))
                model(calib.to(device), update_stats=True)
    state = model.state_dict()

    captured = {}
    for name, spec in specs.items():
        m = build(spec)
        m.load_state_dict(state)
        captured[name] = capture(m.eval(), x)

    rows = []
    for k in captured["qat"]:
        if k not in captured["clamped"] or k not in captured["int8"]:
            continue
        a, b, c = (captured["qat"][k], captured["clamped"][k],
                   captured["int8"][k])
        if a.shape != c.shape:
            continue
        scale = max(float(np.abs(b).max()), 1e-6)
        rows.append({
            "layer": k,
            "shape": list(a.shape),
            "clamped_vs_qat": float(np.abs(b - a).max()) / scale,
            "int8_vs_clamped": float(np.abs(c - b).max()) / scale,
        })
    return rows


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--input_res", type=int, default=128)
    ap.add_argument("--w_bit", type=int, default=4)
    ap.add_argument("--a_bit", type=int, default=8)
    ap.add_argument("--percentile", action="store_true")
    ap.add_argument("--w2", action="store_true")
    ap.add_argument("--maxpool", action="store_true")
    ap.add_argument("--gpus", default="0",
                    help="-1 runs on the CPU; otherwise the CUDA card")
    ap.add_argument("--json", default=None)
    ap.add_argument("--lowering_tol", type=float, default=0.05,
                    help="relative int8-vs-clamped threshold above which "
                         "a layer is flagged as a lowering divergence")
    args = ap.parse_args(argv)

    device = "cpu" if args.gpus.split(",")[0] == "-1" else "cuda"
    rows = run_audit(args.ckpt, args.input_res, w_bit=args.w_bit,
                     a_bit=args.a_bit, percentile=args.percentile,
                     w2=args.w2, maxpool=args.maxpool, device=device)
    print(f"{'layer':60s} {'clamp-vs-qat':>14s} {'int8-vs-clamp':>14s}")
    for r in rows:
        flag = " <-- LOWERING" if r["int8_vs_clamped"] > args.lowering_tol \
            else ""
        print(f"{r['layer'][:60]:60s} {r['clamped_vs_qat']:14.5f} "
              f"{r['int8_vs_clamped']:14.5f}{flag}")
    bad = [r for r in rows if r["int8_vs_clamped"] > args.lowering_tol]
    worst_clamp = max(rows, key=lambda r: r["clamped_vs_qat"])
    print(f"\n{len(rows)} layers; {len(bad)} above the int8 lowering "
          f"tolerance {args.lowering_tol}")
    print(f"largest clamp-semantics divergence: {worst_clamp['layer']} "
          f"({worst_clamp['clamped_vs_qat']:.4f})")
    if args.json:
        with open(args.json, "w") as f:
            json.dump({"rows": rows, "lowering_tol": args.lowering_tol,
                       "flagged": [r["layer"] for r in bad]}, f, indent=1)
        print(f"wrote {args.json}")
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
