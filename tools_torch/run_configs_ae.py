#!/usr/bin/env python
"""One-command reproduction driver for the paper's five configs (a-e),
through the port's CLIs.

The port's copy of the JAX package's tools_tpu/run_configs_ae.py, with
the same configs, flags, defaults, stages and exp ids. Per config, the
reference's recipe (its README.md:88-116):
  1. fp32_train      python -m codenet_torch.cli.main ctdet, 90 epochs,
                     lr_step 50,70
  2. qat_finetune    python -m codenet_torch.cli.quant_main, to epoch 180
                     from the FP32 checkpoint (--resume --resume-quantize
                     --wt-percentile --act_clamp)
  3. eval_fakequant  python -m codenet_torch.cli.test --flip_test
                     --resume-quantize --wt-percentile --act_clamp
                     (results kept as results_fakequant.json)
  4. eval_int8       the same with --int8_infer, the deployed real-int8
                     path (results_int8.json)
  5. export_w4a8     tools_torch/export_w4a8.py packs the W4A8 artifact
                     (model_w4a8.npz: int4 weights two to a byte, scales,
                     folded biases, frozen activation ranges), the
                     counterpart of the reference's published 0.76 MB /
                     2.90 MB parameter files (its README.md:14-18)

QAT trains with --act_clamp, so the matrix describes the deployed model,
as the reference's table does. Configs (its README.md Table 3):
  a: 256x256 stride 4        c: 512x512 stride 4    e: 512x512 --w2 --maxpool
  b: 256x256 --maxpool       d: 512x512 --w2

Each stage is a process of its own (or a call of `runner`); a stage whose
marker exists is skipped (model_last.pth with .fp32_done / .qat_done,
results_{tag}.json, model_w4a8.npz), so the driver resumes. Every stage
runs on the card unless --gpus -1. The wall seconds of each stage, the
exp dir and the reference AP50 target go to
exp/configs_ae_summary_torch.json (a resumed run adds to it); tools_torch/summarize_results.py
scores the kept results into a table. AP50 targets (real VOC, +-0.2):
a 51.1, b 55.1, c 61.7, d 67.1, e 69.7.

Usage:
  python tools_torch/run_configs_ae.py                 # all five
  python tools_torch/run_configs_ae.py --configs a,b   # subset
  python tools_torch/run_configs_ae.py --fp32_epochs 2 --qat_epochs 4 \\
      --data_dir /tmp/vocdata --smoke [--gpus -1]      # a synthetic set
  python tools_torch/run_configs_ae.py --dry_run       # the commands
"""

import argparse
import json
import os
import shutil
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

CONFIGS = {
    "a": {"input_res": 256, "w2": False, "maxpool": False, "ap50": 51.1},
    "b": {"input_res": 256, "w2": False, "maxpool": True, "ap50": 55.1},
    "c": {"input_res": 512, "w2": False, "maxpool": False, "ap50": 61.7},
    "d": {"input_res": 512, "w2": True, "maxpool": False, "ap50": 67.1},
    "e": {"input_res": 512, "w2": True, "maxpool": True, "ap50": 69.7},
}


def summary_path():
    return os.path.join(REPO, "exp", "configs_ae_summary_torch.json")


def _cli(name):
    return [sys.executable, "-m", "codenet_torch.cli." + name]


def build_commands(cfg_name, opts):
    """The exp id and the five (stage, argv) pairs of one config."""
    c = CONFIGS[cfg_name]
    exp = f"pascal_shufflenetv2_config_{cfg_name}"
    flags = ["--arch", "shufflenetv2", "--dataset", "pascal",
             "--head_conv", "64", "--input_res", str(c["input_res"]),
             "--data_dir", opts.data_dir, "--exp_id", exp]
    if c["w2"]:
        flags += ["--w2"]
    if c["maxpool"]:
        flags += ["--maxpool"]
    if getattr(opts, "gpus", None) is not None:
        flags += ["--gpus", str(opts.gpus)]
    extra = []
    if opts.batch_size:
        extra += ["--batch_size", str(opts.batch_size)]
    if opts.num_workers is not None:
        extra += ["--num_workers", str(opts.num_workers)]
    if getattr(opts, "lr", None):
        extra += ["--lr", str(opts.lr)]
    if getattr(opts, "device_cache", False):
        # the train split's raw frames on the card (data/device_cache.py):
        # steps ship row indices and affines, not pixels
        extra += ["--device_cache"]
    if getattr(opts, "save_intervals", None):
        extra += ["--save_intervals", str(opts.save_intervals)]
    if getattr(opts, "val_intervals", None):
        extra += ["--val_intervals", str(opts.val_intervals)]

    train = _cli("main") + ["ctdet", *flags, *extra,
                            "--num_epochs", str(opts.fp32_epochs),
                            "--lr_step", opts.lr_step]
    qat = _cli("quant_main") + ["ctdet", *flags, *extra,
                                "--num_epochs", str(opts.qat_epochs),
                                "--lr_step", opts.lr_step,
                                "--resume", "--resume-quantize",
                                "--wt-percentile", "--act_clamp"]
    # the evals take the QAT stage's weight-range mode (--wt-percentile):
    # without it weights are fake-quantized against min/max ranges the
    # model never trained under
    test_fake = _cli("test") + ["ctdet", *flags,
                                "--resume", "--flip_test", "--resume-quantize",
                                "--wt-percentile", "--act_clamp"]
    test_int8 = _cli("test") + ["ctdet", *flags,
                                "--resume", "--flip_test", "--resume-quantize",
                                "--wt-percentile", "--act_clamp",
                                "--int8_infer"]
    export = [sys.executable, "tools_torch/export_w4a8.py", "ctdet", *flags,
              "--resume", "--resume-quantize", "--wt-percentile",
              "--act_clamp"]
    return exp, [("fp32_train", train), ("qat_finetune", qat),
                 ("eval_fakequant", test_fake), ("eval_int8", test_int8),
                 ("export_w4a8", export)]


def stage_done(exp_dir, stage, opts):
    """Resumability: whether a stage's marker exists."""
    if not os.path.exists(os.path.join(exp_dir, "model_last.pth")):
        return False
    if stage == "fp32_train":
        # the QAT stage overwrites model_last: the FP32 stage's own marker
        return os.path.exists(os.path.join(exp_dir, ".fp32_done"))
    if stage == "qat_finetune":
        return os.path.exists(os.path.join(exp_dir, ".qat_done"))
    if stage.startswith("eval_"):
        tag = stage[len("eval_"):]
        return os.path.exists(os.path.join(exp_dir, f"results_{tag}.json"))
    if stage == "export_w4a8":
        return os.path.exists(os.path.join(exp_dir, "model_w4a8.npz"))
    return False


def main(argv=None, runner=None):
    """Run the configs' stages; 0 when all ran. Each stage's command runs
    as a process, or through `runner` (argv -> exit code) where the
    caller gives one."""
    if runner is None:
        def runner(cmd):
            return subprocess.call(cmd, cwd=REPO)
    ap = argparse.ArgumentParser()
    ap.add_argument("--configs", default="a,b,c,d,e")
    ap.add_argument("--data_dir", default=os.path.join(REPO, "data"))
    ap.add_argument("--fp32_epochs", type=int, default=90)
    ap.add_argument("--qat_epochs", type=int, default=180)
    ap.add_argument("--lr_step", default="50,70")
    ap.add_argument("--batch_size", type=int, default=32)
    ap.add_argument("--num_workers", type=int, default=None)
    ap.add_argument("--retries", type=int, default=2,
                    help="per-stage retries; a train stage retries from "
                         "its own model_last (--resume)")
    ap.add_argument("--lr", type=float, default=None,
                    help="override the reference 1.25e-4 (e.g. scaled for "
                         "a larger batch, or higher for synthetic runs)")
    ap.add_argument("--device_cache", action="store_true",
                    help="train stages keep the raw train images on the "
                         "card (see --device_cache in config.py)")
    ap.add_argument("--save_intervals", type=int, default=None,
                    help="checkpoint every N epochs")
    ap.add_argument("--val_intervals", type=int, default=None,
                    help="validate every N epochs (-1 = never)")
    ap.add_argument("--gpus", default=None,
                    help="passed to every stage (-1: the CPU); by default "
                         "the stages run on the card")
    ap.add_argument("--dry_run", action="store_true",
                    help="print the command lines and exit")
    ap.add_argument("--smoke", action="store_true",
                    help="a synthetic run (tools_torch/synthetic_data.py "
                         "lays out data/voc as real VOC is laid out)")
    args = ap.parse_args(argv)

    voc = os.path.join(args.data_dir, "voc")
    if not os.path.isdir(voc) and not args.dry_run:
        print(f"ERROR: {voc} not found. Fetch Pascal VOC first:\n"
              f"  bash tools_tpu/get_pascal_voc.sh\n"
              f"  python tools_tpu/merge_pascal_json.py", file=sys.stderr)
        return 2

    # a resumed run keeps the seconds of the stages it skips
    summary = {}
    if os.path.exists(summary_path()) and not args.dry_run:
        with open(summary_path()) as f:
            summary = json.load(f)
    for name in args.configs.split(","):
        exp, stages = build_commands(name, args)
        exp_dir = os.path.join(REPO, "exp", "ctdet", exp)
        seconds = dict(summary.get(name, {}).get("stage_seconds", {}))
        for stage, cmd in stages:
            if args.dry_run:
                print(f"[{name}:{stage}] {' '.join(cmd)}")
                continue
            if stage_done(exp_dir, stage, args):
                print(f"[{name}:{stage}] done already, skipping")
                continue
            print(f"[{name}:{stage}] {' '.join(cmd)}", flush=True)
            t0 = time.perf_counter()
            rc = runner(cmd)
            for attempt in range(args.retries):
                if rc == 0:
                    break
                retry_cmd = list(cmd)
                if stage == "fp32_train" and "--resume" not in retry_cmd \
                        and os.path.exists(
                            os.path.join(exp_dir, "model_last.pth")):
                    retry_cmd.append("--resume")
                print(f"[{name}:{stage}] rc={rc}; retry "
                      f"{attempt + 1}/{args.retries}", flush=True)
                rc = runner(retry_cmd)
            seconds[stage] = time.perf_counter() - t0
            if rc != 0:
                print(f"[{name}:{stage}] FAILED rc={rc}", file=sys.stderr)
                return rc
            print(json.dumps({"config": name, "stage": stage,
                              "seconds": seconds[stage]}), flush=True)
            if stage in ("fp32_train", "qat_finetune"):
                marker = ".fp32_done" if stage == "fp32_train" \
                    else ".qat_done"
                open(os.path.join(exp_dir, marker), "w").close()
            elif stage.startswith("eval_"):
                # results.json is rewritten by every cli.test run; the
                # stage-tagged copy is what summarize_results.py scores
                tag = stage[len("eval_"):]
                src = os.path.join(exp_dir, "results.json")
                if os.path.exists(src):
                    shutil.copyfile(
                        src, os.path.join(exp_dir, f"results_{tag}.json"))
        if not args.dry_run:
            summary[name] = {"exp_dir": exp_dir,
                             "target_ap50": CONFIGS[name]["ap50"],
                             "stage_seconds": seconds}
    if summary and not args.dry_run:
        os.makedirs(os.path.dirname(summary_path()), exist_ok=True)
        with open(summary_path(), "w") as f:
            json.dump(summary, f, indent=2)
        print(f"wrote {summary_path()}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
