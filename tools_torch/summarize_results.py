#!/usr/bin/env python
"""Collect the configs a-e matrix of the port into a results table.

The port's copy of the JAX package's tools_tpu/summarize_results.py. It
reads each exp/ctdet/pascal_shufflenetv2_config_<x>/ eval archive that
tools_torch/run_configs_ae.py keeps, results_fakequant.json (QAT
fake-quant eval) and results_int8.json (the deployed real-int8 path,
--int8_infer), re-scores them against the dataset's ground truth with
the port's VOC evaluator (codenet_torch/eval/voc_eval.py), and writes
both APs per config, their difference, the float checkpoint's and the
packed W4A8 artifact's sizes and the reference's target. The targets are
real-VOC numbers, listed for context; on a synthetic set they are not
comparable. The per-stage wall seconds come from
exp/configs_ae_summary_torch.json where it holds them.

The default output is exp/RESULTS_torch.md; the repo's RESULTS.md is the
JAX package's record and is never written here.

Usage: python tools_torch/summarize_results.py --data_dir /tmp/synthvoc \\
           [--out exp/RESULTS_torch.md] [--note "..."] [--cmdline "..."]
"""

import argparse
import json
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, "tools_torch"))

CONFIGS = {
    "a": ("256, stride 4, 1x", 51.1),
    "b": ("256, S2+maxpool, 1x", 55.1),
    "c": ("512, stride 4, 1x", 61.7),
    "d": ("512, stride 4, 2x (--w2)", 67.1),
    "e": ("512, S2+maxpool, 2x", 69.7),
}


def _score_file(results, gt, classes):
    from codenet_torch.eval.voc_eval import voc_eval_from_coco_json
    scores = voc_eval_from_coco_json(results, gt, classes, quiet=True)
    with open(gt) as f:
        present = {a["category_id"] for a in json.load(f)["annotations"]}
    aps = [scores["per_class"][classes[c - 1]] for c in present]
    return {"ap50_all20": scores["AP50"],
            "ap50_present": sum(aps) / max(len(aps), 1),
            "n_present": len(aps)}


def score_config(name, data_dir):
    """One config's scores and sizes, or None where it kept no eval."""
    from synthetic_data import VOC_CLASSES

    exp_dir = os.path.join(REPO, "exp", "ctdet",
                           f"pascal_shufflenetv2_config_{name}")
    gt = os.path.join(data_dir, "voc", "annotations", "pascal_test2007.json")
    out = {"exp_dir": os.path.relpath(exp_dir, REPO)}
    for tag, fn in (("fakequant", "results_fakequant.json"),
                    ("int8", "results_int8.json"),
                    ("latest", "results.json")):
        path = os.path.join(exp_dir, fn)
        if os.path.exists(path):
            out[tag] = _score_file(path, gt, VOC_CLASSES)
    if not any(t in out for t in ("fakequant", "int8", "latest")):
        return None
    ckpt = os.path.join(exp_dir, "model_last.pth")
    if os.path.exists(ckpt):
        out["ckpt_mb"] = os.path.getsize(ckpt) / 1e6
    npz = os.path.join(exp_dir, "model_w4a8.npz")
    if os.path.exists(npz):
        out["w4a8_mb"] = os.path.getsize(npz) / 1e6
    log_lines = []
    for fn in sorted(os.listdir(exp_dir)):
        if fn.startswith("log_"):
            with open(os.path.join(exp_dir, fn)) as f:
                log_lines += [ln.strip() for ln in f if "epoch" in ln]
    if log_lines:
        out["last_epoch_line"] = log_lines[-1]
    summary = os.path.join(REPO, "exp", "configs_ae_summary_torch.json")
    if os.path.exists(summary):
        with open(summary) as f:
            seconds = json.load(f).get(name, {}).get("stage_seconds")
        if seconds:
            out["stage_seconds"] = seconds
    return out


def _fmt(s, tag):
    if s is None or tag not in s:
        return "—"
    return f"{s[tag]['ap50_all20']:.4f}"


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--data_dir", required=True)
    ap.add_argument("--out", default=os.path.join(REPO, "exp",
                                                  "RESULTS_torch.md"))
    ap.add_argument("--note", default="")
    ap.add_argument("--cmdline", default="")
    args = ap.parse_args(argv)
    if os.path.abspath(args.out) == os.path.join(REPO, "RESULTS.md"):
        print("RESULTS.md is the JAX package's record; pick another --out",
              file=sys.stderr)
        return 2

    rows = []
    for name, (desc, ref_ap) in CONFIGS.items():
        s = score_config(name, args.data_dir)
        rows.append((name, desc, ref_ap, s))

    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        f.write("# RESULTS (codenet_torch) — trained checkpoints & "
                "measured AP50\n\n")
        if args.note:
            f.write(args.note.strip() + "\n\n")
        f.write("| config | geometry | AP50 fake-quant | AP50 int8 "
                "(deployed) | int8−fake | float ckpt MB | W4A8 artifact MB "
                "| reference VOC target |\n")
        f.write("|---|---|---|---|---|---|---|---|\n")
        for name, desc, ref_ap, s in rows:
            fq, i8 = _fmt(s, "fakequant"), _fmt(s, "int8")
            delta = "—"
            if s and "fakequant" in s and "int8" in s:
                delta = (f"{s['int8']['ap50_all20'] - s['fakequant']['ap50_all20']:+.4f}")
            ckpt = f"{s['ckpt_mb']:.1f}" if s and "ckpt_mb" in s else "—"
            w4a8 = f"{s['w4a8_mb']:.2f}" if s and "w4a8_mb" in s else "—"
            f.write(f"| {name} | {desc} | {fq} | {i8} | {delta} | {ckpt} | "
                    f"{w4a8} | {ref_ap} |\n")
        f.write("\n")
        if args.cmdline:
            f.write(f"Command line:\n\n```\n{args.cmdline.strip()}\n```\n\n")
        for name, desc, ref_ap, s in rows:
            if s and "last_epoch_line" in s:
                f.write(f"- config {name}: `{s['exp_dir']}` — "
                        f"{s['last_epoch_line']}\n")
            if s and "stage_seconds" in s:
                f.write(f"- config {name} stage seconds: " + ", ".join(
                    f"{k} {v:.1f}" for k, v in s["stage_seconds"].items())
                    + "\n")
    print(f"wrote {args.out}")
    for name, _, _, s in rows:
        if s:
            print(f"  {name}: fakequant={_fmt(s, 'fakequant')} "
                  f"int8={_fmt(s, 'int8')}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
