#!/usr/bin/env python
"""Held-out accuracy regression of the port on a synthetic VOC set.

The port's counterpart of the JAX package's tools_tpu/synthetic_regression.py,
with the same stages, flags, defaults and delta bands: it trains the
flagship ctdet / ShuffleNetV2-DCN on a synthetic VOC train split
(tools_torch/synthetic_data.py, PNG files) and scores Mean AP on
held-out images of the same distribution, each stage a run of the port's
CLIs (``python -m codenet_torch.cli.{main,quant_main,test}``), each score
the port's VOC evaluator. Class identity is colour- or texture-coded, so
generalisation is learnable in minutes yet exercises the whole train ->
checkpoint -> detector -> VOC-eval stack.

Usage:
  python tools_torch/synthetic_regression.py                # run + assert
  python tools_torch/synthetic_regression.py --min_ap 0     # report only
  python tools_torch/synthetic_regression.py --deltas       # delta bands
  python tools_torch/synthetic_regression.py --deltas --smoke

Every stage runs on the card unless ``--gpus -1``. ``--deltas`` writes its
payload to ``--out_json`` (default exp/synthdelta_deltas.json) and exits 1
on a band violation; ``--smoke`` runs the delta harness at SMOKE's size
and holds only the bands that hold at any training length (SMOKE_BANDS),
with the fp32 and qat_clamped APs at SMOKE_MIN_AP or above. One JSON line is printed as each stage ends, so a
cut run still shows what it did; a stage whose marker file exists (it
ended before) is not run again.
"""

import argparse
import json
import math
import os
import shutil
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, "tools_torch"))


def _cli(name):
    return [sys.executable, "-m", "codenet_torch.cli." + name]


def _emit(obj):
    print(json.dumps(obj), flush=True)


def run(train_images=64, test_images=16, input_res=128, batch_size=16,
        num_epochs=400, lr=1e-3, exp_id="synthreg", data_root=None,
        seed=0, num_classes=8, min_side=32, gpus="0"):
    """Train FP32 on a flat-colour synthetic split and score the held-out
    images. Returns (present-class Mean AP, data root)."""
    from synthetic_data import make_voc_dataset

    data_root = data_root or os.path.join(REPO, "exp", exp_id + "_data")
    make_voc_dataset(data_root, num_images=train_images, img_w=160,
                     img_h=120, seed=seed, test_images=test_images,
                     num_classes=num_classes, min_side=min_side)
    common = ["ctdet", "--dataset", "pascal", "--arch", "shufflenetv2",
              "--input_res", str(input_res), "--data_dir", data_root,
              "--exp_id", exp_id, "--gpus", str(gpus)]
    train = _cli("main") + [*common,
                            "--batch_size", str(batch_size),
                            "--num_epochs", str(num_epochs),
                            "--lr", str(lr),
                            "--lr_step", str(int(num_epochs * 0.8)),
                            "--no_color_aug", "--save_intervals", "100",
                            "--num_workers", "1", "--val_intervals", "-1",
                            "--seed", str(seed)]
    test = _cli("test") + [*common, "--resume"]
    for cmd in (train, test):
        print("+", " ".join(cmd), flush=True)
        rc = subprocess.call(cmd, cwd=REPO)
        if rc != 0:
            raise SystemExit(f"stage failed rc={rc}")
    mean_present = _score(exp_id, data_root)
    print(f"present-class Mean AP = {mean_present:.4f}")
    return mean_present, data_root


def _score(exp_id, data_root):
    """Mean VOC AP50 over the classes present in the held-out ground
    truth (absent classes score 0 by VOC convention and would only
    dilute the band), of exp/ctdet/<exp_id>/results.json."""
    from codenet_torch.eval.voc_eval import voc_eval_from_coco_json
    from synthetic_data import VOC_CLASSES
    results = os.path.join(REPO, "exp", "ctdet", exp_id, "results.json")
    gt = os.path.join(data_root, "voc", "annotations",
                      "pascal_test2007.json")
    scores = voc_eval_from_coco_json(results, gt, VOC_CLASSES, quiet=True)
    with open(gt) as f:
        present = {a["category_id"] for a in json.load(f)["annotations"]}
    aps = [scores["per_class"][VOC_CLASSES[c - 1]] for c in present]
    return float(sum(aps) / max(len(aps), 1))


# The JAX package's bands, unchanged (calibrated there on the adversarial
# distribution: 96 train / 24 held-out images at 128^2, 400 + 200
# epochs). int8 clamps activations to the signed window where the
# fake-quant does not, so `qat_clamped` evaluates the same checkpoint with
# clamped fake-quant, and int8 must match that tightly.
DELTA_BANDS = {
    "qat_vs_fp32": -0.10,        # QAT W4A8 fine-tune cost bound
    "int8_vs_clamped": -0.03,    # int8 == clamped fake-quant numerics
    "int8_vs_qat": -0.15,        # informational: includes the clamp cost
    "bf16_vs_fp32": -0.02,       # bf16 eval ~= f32 eval
    "flip_vs_plain": -0.02,      # flip-test must not hurt
    "int8_ct_vs_qat_ct": -0.03,  # deployed recipe: clamp-trained QAT ->
                                 # int8 loses only requant noise
    "qat_ct_vs_qat": -0.08,      # clamp-trained QAT ~= plain QAT accuracy
}
# the bands that hold at any training length (numerics only), and the
# smoke size: the FP32 training of the full run, QAT cut to 40 epochs,
# the train frames held on the device (--device_cache: the one loader
# thread takes ~160 ms a batch of 16 on one H100's host, 5x a 128^2
# FP32 step). At 80 + 2 x 8 epochs the APs were 0.011-0.029, under the
# bands' own width, where a broken int8 path passes. SMOKE_MIN_AP is the
# floor of the two APs the bands subtract from, so that each band holds
# something above 0.
SMOKE_BANDS = ("int8_vs_clamped", "bf16_vs_fp32")
SMOKE = {"train_images": 96, "test_images": 24, "num_epochs": 400,
         "qat_epochs": 40, "device_cache": True}
SMOKE_MIN_AP = 0.10


def run_deltas(train_images=96, test_images=24, input_res=128,
               batch_size=16, num_epochs=500, qat_epochs=200, lr=1e-3,
               data_root=None, seed=0, out_json=None, gpus="0",
               exp_prefix="synthdelta", runner=None, device_cache=False):
    """Train FP32 on the adversarial synthetic split, then QAT and
    clamp-trained QAT from it; score the held-out AP of fp32, fp32 +
    flip, bf16, QAT fake-quant, clamped fake-quant and real int8 of each
    QAT, and hold the deltas to DELTA_BANDS. Returns (payload, data
    root); the payload is also written to `out_json`.

    Each stage's command runs as a subprocess, or through `runner`
    (command -> exit code) where the caller gives one: chip_smoke.py
    runs the CLIs' entry points in its own process, where it counts
    their kernel launches."""
    if runner is None:
        def runner(cmd):
            return subprocess.call(cmd, cwd=REPO)
    from synthetic_data import make_voc_dataset

    t_start = time.perf_counter()
    data_root = data_root or os.path.join(REPO, "exp",
                                          exp_prefix + "_data")
    make_voc_dataset(data_root, num_images=train_images, img_w=160,
                     img_h=120, seed=seed, test_images=test_images,
                     num_classes=20, min_side=8, max_objects=5,
                     adversarial=True)
    common = ["ctdet", "--dataset", "pascal", "--arch", "shufflenetv2",
              "--input_res", str(input_res), "--data_dir", data_root,
              "--num_workers", "1", "--seed", str(seed), "--gpus",
              str(gpus)]
    trainflags = ["--batch_size", str(batch_size), "--lr", str(lr),
                  "--no_color_aug", "--save_intervals", "100",
                  "--val_intervals", "-1"]
    if device_cache:
        # the train split's frames read once and warped on the device:
        # the sampler's draws unchanged, the loader thread's warps gone
        trainflags.append("--device_cache")
    fp32, qat = exp_prefix + "_fp32", exp_prefix + "_qat"
    qat_ct = exp_prefix + "_qatct"
    fp32_ckpt = os.path.join(REPO, "exp", "ctdet", fp32, "model_last.pth")
    stages = [
        ("fp32_train", _cli("main") + [*common, *trainflags,
                                       "--exp_id", fp32,
                                       "--num_epochs", str(num_epochs),
                                       "--lr_step",
                                       str(int(num_epochs * 0.8))]),
        ("qat_train", _cli("quant_main") + [
            *common, *trainflags, "--exp_id", qat,
            "--num_epochs", str(qat_epochs),
            "--lr_step", str(int(qat_epochs * 0.8)),
            "--load_model", fp32_ckpt, "--wt-percentile"]),
        # deployment-faithful QAT: trained with the int8 window clamp, so
        # the network adapts to saturation instead of paying for it when
        # it is lowered to int8
        ("qat_ct_train", _cli("quant_main") + [
            *common, *trainflags, "--exp_id", qat_ct,
            "--num_epochs", str(qat_epochs),
            "--lr_step", str(int(qat_epochs * 0.8)),
            "--load_model", fp32_ckpt, "--wt-percentile", "--act_clamp"]),
    ]
    test = _cli("test")
    evals = [
        ("fp32", test + [*common, "--exp_id", fp32, "--resume"]),
        ("fp32_flip", test + [*common, "--exp_id", fp32, "--resume",
                              "--flip_test"]),
        ("bf16", test + [*common, "--exp_id", fp32, "--resume",
                         "--dtype", "bfloat16"]),
        ("qat", test + [*common, "--exp_id", qat, "--resume",
                        "--resume-quantize", "--wt-percentile"]),
        ("qat_clamped", test + [*common, "--exp_id", qat, "--resume",
                                "--resume-quantize", "--wt-percentile",
                                "--act_clamp"]),
        ("int8", test + [*common, "--exp_id", qat, "--resume",
                         "--resume-quantize", "--wt-percentile",
                         "--int8_infer"]),
        ("qat_ct", test + [*common, "--exp_id", qat_ct, "--resume",
                           "--resume-quantize", "--wt-percentile",
                           "--act_clamp"]),
        ("int8_ct", test + [*common, "--exp_id", qat_ct, "--resume",
                            "--resume-quantize", "--wt-percentile",
                            "--int8_infer"]),
    ]
    seconds = {}
    for name, cmd in stages:
        exp_dir = os.path.join(REPO, "exp", "ctdet",
                               cmd[cmd.index("--exp_id") + 1])
        marker = os.path.join(exp_dir, f".{name}_done")
        if os.path.exists(marker):
            print(f"[deltas] {name} done already, skipping", flush=True)
            continue
        print("+", " ".join(cmd), flush=True)
        t0 = time.perf_counter()
        rc = runner(cmd)
        seconds[name] = time.perf_counter() - t0
        _emit({"synthreg_stage": name, "rc": rc,
               "seconds": seconds[name]})
        if rc != 0:
            raise SystemExit(f"{name} failed")
        os.makedirs(exp_dir, exist_ok=True)
        open(marker, "w").close()
    aps = {}
    for name, cmd in evals:
        print("+", " ".join(cmd), flush=True)
        t0 = time.perf_counter()
        rc = runner(cmd)
        seconds[name] = time.perf_counter() - t0
        if rc != 0:
            _emit({"synthreg_eval": name, "rc": rc,
                   "seconds": seconds[name]})
            raise SystemExit(f"eval {name} failed")
        exp = fp32 if "fp32" in name or name == "bf16" else (
            qat_ct if name.endswith("_ct") else qat)
        aps[name] = _score(exp, data_root)
        _emit({"synthreg_eval": name, "rc": rc, "seconds": seconds[name],
               "ap": aps[name]})
    deltas = {
        "qat_vs_fp32": aps["qat"] - aps["fp32"],
        "int8_vs_clamped": aps["int8"] - aps["qat_clamped"],
        "int8_vs_qat": aps["int8"] - aps["qat"],
        "bf16_vs_fp32": aps["bf16"] - aps["fp32"],
        "flip_vs_plain": aps["fp32_flip"] - aps["fp32"],
        # the deployment recipe: clamp-trained QAT -> int8 must be
        # lossless (both run the same saturated ranges)
        "int8_ct_vs_qat_ct": aps["int8_ct"] - aps["qat_ct"],
        # and clamp-training must not cost much against plain QAT
        "qat_ct_vs_qat": aps["qat_ct"] - aps["qat"],
    }
    violations = {k: d for k, d in deltas.items() if d < DELTA_BANDS[k]}
    payload = {"aps": aps, "deltas": deltas, "bands": DELTA_BANDS,
               "violations": violations, "seconds": seconds,
               "wall_s": time.perf_counter() - t_start,
               "config": {"train_images": train_images,
                          "test_images": test_images,
                          "input_res": input_res, "epochs": num_epochs,
                          "qat_epochs": qat_epochs, "seed": seed,
                          "adversarial": True, "frames": "png",
                          "device_cache": device_cache,
                          "gpus": str(gpus)}}
    out_json = out_json or os.path.join(REPO, "exp",
                                        exp_prefix + "_deltas.json")
    os.makedirs(os.path.dirname(os.path.abspath(out_json)), exist_ok=True)
    with open(out_json, "w") as f:
        json.dump(payload, f, indent=1)
    _emit({"deltas": {k: round(v, 4) for k, v in deltas.items()},
           "violations": sorted(violations)})
    return payload, data_root


def smoke_failures(payload):
    """What a --smoke run fails: an AP that is not finite, an fp32 or
    qat_clamped AP under SMOKE_MIN_AP, or a band of SMOKE_BANDS."""
    aps = payload["aps"]
    failed = sorted(k for k, v in aps.items() if not math.isfinite(v))
    failed += ["{} AP >= {}".format(k, SMOKE_MIN_AP)
               for k in ("fp32", "qat_clamped")
               if not aps[k] >= SMOKE_MIN_AP]
    failed += [k for k in SMOKE_BANDS
               if not payload["deltas"][k] >= DELTA_BANDS[k]]
    return failed


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--min_ap", type=float, default=0.50,
                    help="lower band of the absolute-AP run")
    ap.add_argument("--train_images", type=int, default=64)
    ap.add_argument("--test_images", type=int, default=16)
    ap.add_argument("--input_res", type=int, default=128)
    ap.add_argument("--batch_size", type=int, default=16)
    ap.add_argument("--num_epochs", type=int, default=400)
    ap.add_argument("--qat_epochs", type=int, default=200)
    ap.add_argument("--num_classes", type=int, default=8)
    ap.add_argument("--keep_data", action="store_true")
    ap.add_argument("--deltas", action="store_true",
                    help="run the adversarial-distribution delta harness "
                         "(fp32/flip/bf16/QAT/int8 bands) instead of the "
                         "absolute-AP band")
    ap.add_argument("--smoke", action="store_true",
                    help="with --deltas: SMOKE's size, SMOKE_BANDS held")
    ap.add_argument("--gpus", default="0",
                    help="passed to every CLI stage; -1 runs on the CPU")
    ap.add_argument("--out_json", default=None)
    args = ap.parse_args(argv)

    if args.deltas:
        if args.smoke:
            payload, data_root = run_deltas(
                input_res=args.input_res, batch_size=args.batch_size,
                out_json=args.out_json, gpus=args.gpus,
                exp_prefix="synthsmoke", **SMOKE)
            failed = smoke_failures(payload)
        else:
            payload, data_root = run_deltas(
                max(args.train_images, 96), max(args.test_images, 24),
                args.input_res, args.batch_size, args.num_epochs,
                args.qat_epochs, out_json=args.out_json, gpus=args.gpus)
            failed = sorted(payload["violations"])
        if not args.keep_data:
            shutil.rmtree(data_root, ignore_errors=True)
        if failed:
            print("REGRESSION: delta band violation:", failed,
                  file=sys.stderr)
            return 1
        return 0

    mean_ap, data_root = run(args.train_images, args.test_images,
                             args.input_res, args.batch_size,
                             args.num_epochs, num_classes=args.num_classes,
                             gpus=args.gpus)
    print(f"synthetic_regression: held-out Mean AP = {mean_ap:.4f} "
          f"(band >= {args.min_ap})")
    if not args.keep_data:
        shutil.rmtree(data_root, ignore_errors=True)
    if mean_ap < args.min_ap:
        print("REGRESSION: AP below pinned band", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
