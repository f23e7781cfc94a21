"""Flag system and run configuration.

CLI-compatible with the reference's ``lib/opts.py`` (same flag names, same
derivation rules: head dicts per task, input/output resolutions, directory
layout, resume paths). Its own copy of the JAX package's config, so that
the PyTorch package imports nothing from it.

``--gpus`` keeps the reference meaning: ``--gpus -1`` runs on the CPU,
anything else on CUDA cards, and a list of several ids trains on each of
them (one data-parallel rank per card: cli/main.py); ``opt.gpus`` is
0..n-1 as in the reference and ``opt.gpus_str`` keeps the ids. Flags
that only the JAX package implements (spatial sharding, ...) are
accepted so command lines stay interchangeable; the PyTorch entry points
that do not implement one raise when it is set.

Reference: lib/opts.py:9-386.
"""

from __future__ import annotations

import argparse
import os
import sys
from types import SimpleNamespace


# Per-dataset static specs (reference: lib/datasets/dataset/*.py class attrs).
DATASET_SPECS = {
    "coco": dict(
        num_classes=80,
        default_resolution=[512, 512],
        mean=[0.408, 0.447, 0.470],
        std=[0.289, 0.274, 0.278],
        max_objs=128,
    ),
    "pascal": dict(
        num_classes=20,
        default_resolution=[384, 384],
        mean=[0.485, 0.456, 0.406],
        std=[0.229, 0.224, 0.225],
        max_objs=50,
    ),
    "kitti": dict(
        num_classes=3,
        default_resolution=[384, 1280],
        mean=[0.485, 0.456, 0.406],
        std=[0.229, 0.224, 0.225],
        max_objs=50,
    ),
    "coco_hp": dict(
        num_classes=1,
        default_resolution=[512, 512],
        mean=[0.408, 0.447, 0.470],
        std=[0.289, 0.274, 0.278],
        max_objs=32,
        num_joints=17,
        flip_idx=[[1, 2], [3, 4], [5, 6], [7, 8], [9, 10],
                  [11, 12], [13, 14], [15, 16]],
    ),
}

# Default dataset per task (reference lib/opts.py:360-386 `init`).
TASK_DEFAULT_DATASET = {
    "ctdet": "coco",
    "exdet": "coco",
    "multi_pose": "coco_hp",
    "ddd": "kitti",
}


def build_parser() -> argparse.ArgumentParser:
    """All reference flags (lib/opts.py:13-248), same names and defaults."""
    p = argparse.ArgumentParser(description="codenet-torch")
    # basic experiment setting
    p.add_argument("task", default="ctdet", nargs="?",
                   help="ctdet | ddd | multi_pose | exdet")
    p.add_argument("--dataset", default="coco",
                   help="coco | kitti | coco_hp | pascal")
    p.add_argument("--exp_id", default="default")
    p.add_argument("--test", action="store_true")
    p.add_argument("--debug", type=int, default=0)
    p.add_argument("--demo", default="")
    p.add_argument("--load_model", default="")
    p.add_argument("--resume", action="store_true")
    # system
    p.add_argument("--gpus", default="0",
                   help="-1 runs on the CPU; otherwise the CUDA card")
    p.add_argument("--num_workers", type=int, default=4)
    p.add_argument("--not_cuda_benchmark", action="store_true")
    p.add_argument("--seed", type=int, default=317)
    # log
    p.add_argument("--print_iter", type=int, default=0)
    p.add_argument("--hide_data_time", action="store_true")
    p.add_argument("--save_all", action="store_true")
    p.add_argument("--metric", default="loss")
    p.add_argument("--vis_thresh", type=float, default=0.3)
    p.add_argument("--debugger_theme", default="white",
                   choices=["white", "black"])
    # model
    p.add_argument("--arch", default="dla_34")
    p.add_argument("--head_conv", type=int, default=-1)
    p.add_argument("--down_ratio", type=int, default=4)
    p.add_argument("--deform_conv", type=str, default="DeformConvPack")
    # input
    p.add_argument("--input_res", type=int, default=-1)
    p.add_argument("--input_h", type=int, default=-1)
    p.add_argument("--input_w", type=int, default=-1)
    # train
    p.add_argument("--lr", type=float, default=1.25e-4)
    p.add_argument("--lr_step", type=str, default="90,120")
    p.add_argument("--num_epochs", type=int, default=140)
    p.add_argument("--batch_size", type=int, default=32)
    p.add_argument("--master_batch_size", type=int, default=-1)
    p.add_argument("--num_iters", type=int, default=-1)
    p.add_argument("--val_intervals", type=int, default=5)
    p.add_argument("--trainval", action="store_true")
    # test
    p.add_argument("--flip_test", action="store_true")
    p.add_argument("--test_scales", type=str, default="1")
    p.add_argument("--nms", action="store_true")
    p.add_argument("--K", type=int, default=100)
    p.add_argument("--not_prefetch_test", action="store_true")
    # extension (not in reference opts.py): batched single-scale eval
    p.add_argument("--batch_eval", type=int, default=0,
                   help="batch N images per fused eval program (ctdet, "
                        "single scale, fixed res); 0 = reference behavior")
    p.add_argument("--spatial_shard", type=int, default=1,
                   help="extension: shard the image H axis over this "
                        "many devices on a 2-D (data, spatial) mesh — "
                        "GSPMD spatially partitions the backbone convs "
                        "with halo exchange (high-res scaling past "
                        "per-chip batch granularity)")
    p.add_argument("--act_clamp", action="store_true",
                   help="QAT/eval fake-quant clamps activations to the signed\n                        int8 window (deployment-faithful; the reference does not)")
    p.add_argument("--trace", action="store_true",
                   help="capture a profiler trace of the eval loop")
    p.add_argument("--device_warp", action="store_true",
                   help="with --batch_eval: run the letterbox warp on "
                        "device instead of cv2 on host")
    p.add_argument("--device_warp_max_res", type=int, default=768,
                   help="static raw-image buffer size for --device_warp; "
                        "larger images fall back to host warp")
    # extension (data/device_cache.py): keep the whole train split's
    # raw pixels on device and ship only (img_idx, warp matrix, aug
    # state, sparse targets) per step — per-step host->device traffic
    # drops from ~200 KB/img to ~50 B/img, which turns feed-bound
    # training (thin tunnel or slow disk) back into compute-bound.
    p.add_argument("--device_cache", action="store_true",
                   help="cache the train split's raw images in HBM and "
                        "warp/augment on device (random aug stream is "
                        "unchanged; interpolation moves from cv2 "
                        "fixed-point to f32)")
    p.add_argument("--device_cache_shard", action="store_true",
                   help="partition the HBM image cache's rows over the "
                        "data mesh axis instead of replicating (cache "
                        "scales with the pod: each chip holds N/D rows; "
                        "the loader routes each batch slot-block to the "
                        "shard that owns it). Implies --device_cache.")
    # extension: ship uint8 inputs and run color-aug + normalization
    # inside the jitted step (4x less host->device traffic). Set
    # --host_normalize for the reference's host-side numpy path.
    p.add_argument("--host_normalize", action="store_true",
                   help="normalize/color-aug on host (reference behavior) "
                        "instead of on device")
    # extension: checkpoint cadence. The reference writes model_last
    # every epoch; with many tiny epochs (or a thin host link) the
    # params device->host pull dominates wall time.
    p.add_argument("--save_intervals", type=int, default=1,
                   help="write model_last every N epochs (final epoch "
                        "always saves); 1 = reference behavior")
    p.add_argument("--fix_res", action="store_true")
    p.add_argument("--keep_res", action="store_true")
    # dataset / augmentation
    p.add_argument("--not_rand_crop", action="store_true")
    p.add_argument("--shift", type=float, default=0.1)
    p.add_argument("--scale", type=float, default=0.4)
    p.add_argument("--rotate", type=float, default=0)
    p.add_argument("--flip", type=float, default=0.5)
    p.add_argument("--no_color_aug", action="store_true")
    p.add_argument("--aug_rot", type=float, default=0)
    p.add_argument("--aug_ddd", type=float, default=0.5)
    p.add_argument("--rect_mask", action="store_true")
    p.add_argument("--kitti_split", default="3dop")
    # loss
    p.add_argument("--mse_loss", action="store_true")
    p.add_argument("--hm_gauss", type=int, default=4,
                   help="fixed gaussian sigma for --mse_loss targets "
                        "(the reference reads opt.hm_gauss in its samplers "
                        "but never declares the flag — mse mode crashes "
                        "there; declared here)")
    p.add_argument("--reg_loss", default="l1")
    p.add_argument("--hm_weight", type=float, default=1)
    p.add_argument("--off_weight", type=float, default=1)
    p.add_argument("--wh_weight", type=float, default=0.1)
    p.add_argument("--hp_weight", type=float, default=1)
    p.add_argument("--hm_hp_weight", type=float, default=1)
    p.add_argument("--dep_weight", type=float, default=1)
    p.add_argument("--dim_weight", type=float, default=1)
    p.add_argument("--rot_weight", type=float, default=1)
    p.add_argument("--peak_thresh", type=float, default=0.2)
    # task-specific
    p.add_argument("--norm_wh", action="store_true")
    p.add_argument("--dense_wh", action="store_true")
    p.add_argument("--cat_spec_wh", action="store_true")
    p.add_argument("--not_reg_offset", action="store_true")
    p.add_argument("--agnostic_ex", action="store_true")
    p.add_argument("--scores_thresh", type=float, default=0.1)
    p.add_argument("--center_thresh", type=float, default=0.1)
    p.add_argument("--aggr_weight", type=float, default=0.0)
    p.add_argument("--dense_hp", action="store_true")
    p.add_argument("--not_hm_hp", action="store_true")
    p.add_argument("--not_reg_hp_offset", action="store_true")
    p.add_argument("--not_reg_bbox", action="store_true")
    # oracle probes
    p.add_argument("--eval_oracle_hm", action="store_true")
    p.add_argument("--eval_oracle_wh", action="store_true")
    p.add_argument("--eval_oracle_offset", action="store_true")
    p.add_argument("--eval_oracle_kps", action="store_true")
    p.add_argument("--eval_oracle_hmhp", action="store_true")
    p.add_argument("--eval_oracle_hp_offset", action="store_true")
    p.add_argument("--eval_oracle_dep", action="store_true")
    # CoDeNet architecture flags
    p.add_argument("--w2", action="store_true",
                   help="double the backbone channels")
    p.add_argument("--maxpool", action="store_true",
                   help="stride-2 conv + maxpool instead of stride-4 conv")
    # quantization
    p.add_argument("--resume-quantize", action="store_true", dest="resume_quantize")
    p.add_argument("--wt-percentile", action="store_true", dest="wt_percentile")
    p.add_argument("--act-percentile", action="store_true", dest="act_percentile")
    p.add_argument("--w-bit", type=int, default=4, dest="w_bit")
    p.add_argument("--a-bit", type=int, default=8, dest="a_bit")
    # extras (no reference counterpart)
    p.add_argument("--dtype", default="float32",
                   help="compute dtype for the conv path: float32 | bfloat16")
    p.add_argument("--data_dir", default="",
                   help="override the data directory (default <root>/data)")
    p.add_argument("--int8_infer", action="store_true",
                   help="lower the quantized model to real int8 convolutions "
                        "for inference")
    p.add_argument("--w4a8_artifact", default="",
                   help="load weights from a packed W4A8 deployment "
                        "artifact (tools_torch/export_w4a8.py) instead of a "
                        "checkpoint; requires --resume-quantize "
                        "--int8_infer (bit-identical to the exported "
                        "model's int8 eval)")
    return p


def parse(args=None, root_dir=None):
    """Parse argv-style args into a config namespace.

    Mirrors reference lib/opts.py:251-306 `parse` derivations.
    """
    parser = build_parser()
    if args is None:
        args = sys.argv[1:]
    elif isinstance(args, str):
        args = args.split()
    args = list(args)
    opt = parser.parse_args(args)
    # the options the command line gives (a later --resume-quantize load
    # takes the checkpoint's quantization recipe for the others)
    given = build_parser()
    for action in given._actions:
        action.default = argparse.SUPPRESS
    opt.given_flags = frozenset(vars(given.parse_args(args)))

    opt.gpus_str = opt.gpus
    gpus = [int(g) for g in opt.gpus.split(",")]
    opt.gpus = list(range(len(gpus))) if gpus[0] >= 0 else [-1]
    opt.lr_step = [int(i) for i in str(opt.lr_step).split(",")]
    opt.test_scales = [float(i) for i in str(opt.test_scales).split(",")]

    if opt.device_cache_shard:
        opt.device_cache = True
    opt.fix_res = not opt.keep_res
    opt.reg_offset = not opt.not_reg_offset
    opt.reg_bbox = not opt.not_reg_bbox
    opt.hm_hp = not opt.not_hm_hp
    opt.reg_hp_offset = (not opt.not_reg_hp_offset) and opt.hm_hp

    if opt.head_conv == -1:
        opt.head_conv = 256 if "dla" in opt.arch else 64
    opt.pad = 127 if "hourglass" in opt.arch else 31
    opt.num_stacks = 2 if opt.arch == "hourglass" else 1

    if opt.trainval:
        opt.val_intervals = 100000000

    if opt.debug > 0:
        opt.num_workers = 0
        opt.batch_size = 1
        opt.gpus = [opt.gpus[0]]
        opt.master_batch_size = -1

    # Legacy uneven-chunk data parallelism (reference lib/opts.py:284-293,
    # lib/models/scatter_gather.py): the data-parallel ranks take equal
    # shares of the batch, so chunk_sizes is recorded for log parity but
    # unused (--master_batch_size is a warned no-op, as in the JAX
    # package).
    if opt.master_batch_size == -1:
        opt.master_batch_size = opt.batch_size // len(opt.gpus)
    rest = opt.batch_size - opt.master_batch_size
    opt.chunk_sizes = [opt.master_batch_size]
    for i in range(len(opt.gpus) - 1):
        chunk = rest // (len(opt.gpus) - 1)
        if i < rest % (len(opt.gpus) - 1):
            chunk += 1
        opt.chunk_sizes.append(chunk)
    if len(set(opt.chunk_sizes)) > 1:
        print("warning: uneven chunk_sizes {} are a no-op here; "
              "batches split evenly across the cards".format(
                  opt.chunk_sizes))

    opt.root_dir = root_dir or os.path.join(
        os.path.dirname(__file__), "..")
    if not opt.data_dir:
        opt.data_dir = os.path.join(opt.root_dir, "data")
    opt.exp_dir = os.path.join(opt.root_dir, "exp", opt.task)
    opt.save_dir = os.path.join(opt.exp_dir, opt.exp_id)
    opt.debug_dir = os.path.join(opt.save_dir, "debug")

    if opt.resume and opt.load_model == "":
        model_path = opt.save_dir[:-4] if opt.save_dir.endswith("TEST") \
            else opt.save_dir
        opt.load_model = os.path.join(model_path, "model_last.pth")
    return opt


def update_dataset_info_and_set_heads(opt, dataset_spec):
    """Derive input/output resolutions and per-task head dicts.

    Mirrors reference lib/opts.py:308-358. `dataset_spec` is a dict from
    DATASET_SPECS or any object with the same keys.
    """
    if not isinstance(dataset_spec, dict):
        dataset_spec = {k: getattr(dataset_spec, k)
                        for k in ("num_classes", "default_resolution",
                                  "mean", "std")
                        if hasattr(dataset_spec, k)}
    input_h, input_w = dataset_spec["default_resolution"]
    opt.mean, opt.std = dataset_spec["mean"], dataset_spec["std"]
    opt.num_classes = dataset_spec["num_classes"]

    input_h = opt.input_res if opt.input_res > 0 else input_h
    input_w = opt.input_res if opt.input_res > 0 else input_w
    opt.input_h = opt.input_h if opt.input_h > 0 else input_h
    opt.input_w = opt.input_w if opt.input_w > 0 else input_w
    opt.output_h = opt.input_h // opt.down_ratio
    opt.output_w = opt.input_w // opt.down_ratio
    opt.input_res = max(opt.input_h, opt.input_w)
    opt.output_res = max(opt.output_h, opt.output_w)

    if opt.task == "exdet":
        num_hm = 1 if opt.agnostic_ex else opt.num_classes
        opt.heads = {"hm_t": num_hm, "hm_l": num_hm,
                     "hm_b": num_hm, "hm_r": num_hm,
                     "hm_c": opt.num_classes}
        if opt.reg_offset:
            opt.heads.update({"reg_t": 2, "reg_l": 2, "reg_b": 2, "reg_r": 2})
    elif opt.task == "ddd":
        opt.heads = {"hm": opt.num_classes, "dep": 1, "rot": 8, "dim": 3}
        if opt.reg_bbox:
            opt.heads.update({"wh": 2})
        if opt.reg_offset:
            opt.heads.update({"reg": 2})
    elif opt.task == "ctdet":
        opt.heads = {"hm": opt.num_classes,
                     "wh": 2 if not opt.cat_spec_wh else 2 * opt.num_classes}
        if opt.reg_offset:
            opt.heads.update({"reg": 2})
    elif opt.task == "multi_pose":
        opt.flip_idx = dataset_spec.get("flip_idx",
                                        DATASET_SPECS["coco_hp"]["flip_idx"])
        opt.heads = {"hm": opt.num_classes, "wh": 2, "hps": 34}
        if opt.reg_offset:
            opt.heads.update({"reg": 2})
        if opt.hm_hp:
            opt.heads.update({"hm_hp": 17})
        if opt.reg_hp_offset:
            opt.heads.update({"hp_offset": 2})
    else:
        raise ValueError("task not defined: {}".format(opt.task))
    return opt


def init(args=None, root_dir=None):
    """Build a full config without constructing a dataset.

    Mirrors reference lib/opts.py:360-386 `opts.init`: uses per-task default
    dataset specs.
    """
    opt = parse(args, root_dir=root_dir)
    dataset = TASK_DEFAULT_DATASET[opt.task]
    opt.dataset = dataset
    return update_dataset_info_and_set_heads(opt, DATASET_SPECS[dataset])


def init_for_dataset(args=None, root_dir=None):
    """Parse and derive heads from the --dataset flag (used by CLIs)."""
    opt = parse(args, root_dir=root_dir)
    spec = DATASET_SPECS[opt.dataset]
    return update_dataset_info_and_set_heads(opt, spec)


def as_namespace(**kwargs) -> SimpleNamespace:
    """Build a config programmatically (library use / tests)."""
    defaults = init_for_dataset(
        [kwargs.pop("task", "ctdet")]
        + ["--{}".format(k) for k in () ])
    for k, v in kwargs.items():
        setattr(defaults, k, v)
    return defaults
