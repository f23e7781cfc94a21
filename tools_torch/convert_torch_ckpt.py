#!/usr/bin/env python
"""A reference CoDeNet checkpoint, or a pytorchcv ImageNet ShuffleNetV2,
as a port .pth (the port's copy of the JAX package's
tools_tpu/convert_torch_ckpt.py, which writes a JAX .ckpt from the same
inputs): the state_dict in the reference layout that `--load_model`
reads, through the port's loader (engine/checkpoint.py::read_checkpoint):
DataParallel prefixes stripped; of a pytorchcv file its backbone alone
(layer0-layer4, renamed), so a model loading it keeps its neck and heads
at their init. `--heads` keeps only those heads of a reference file (the
JAX converter reads only those).

  python tools_torch/convert_torch_ckpt.py model_last.pth out.pth \\
      [--heads hm,wh,reg] [--pytorchcv_backbone]
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from codenet_torch.engine.checkpoint import read_checkpoint  # noqa: E402

# the reference ShuffleNetV2's top-level modules other than its heads
BODY = ("layer0", "layer1", "layer2", "layer3", "layer4", "deconv_layers")


def convert(src, heads=None, pytorchcv_backbone=False):
    """(epoch, state_dict) of `src` as the port loads it; `heads`: the
    head names to keep (None: all); `pytorchcv_backbone`: src must hold a
    backbone alone, as a pytorchcv file gives one."""
    epoch, sd = read_checkpoint(src)
    top = {k.split(".")[0] for k in sd}
    if pytorchcv_backbone and not top <= set(BODY[:5]):
        raise SystemExit("{}: not a pytorchcv backbone (top-level keys "
                         "{})".format(src, sorted(top - set(BODY[:5]))))
    if heads is not None:
        sd = {k: v for k, v in sd.items()
              if k.split(".")[0] in BODY or k.split(".")[0] in heads}
    return epoch, sd


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("src")
    ap.add_argument("dst")
    ap.add_argument("--heads", default="hm,wh,reg")
    ap.add_argument("--pytorchcv_backbone", action="store_true",
                    help="src is a pytorchcv shufflenetv2 checkpoint; "
                         "convert only the backbone (partial warm start)")
    args = ap.parse_args(argv)
    import torch
    epoch, sd = convert(args.src, args.heads.split(","),
                        args.pytorchcv_backbone)
    torch.save({"epoch": epoch, "state_dict": sd}, args.dst)
    print("wrote {}".format(args.dst))


if __name__ == "__main__":
    main()
