#!/usr/bin/env python
"""Export the W4A8 deployment artifact of a port QAT checkpoint.

The reference publishes its models as the quantizer's 4-bit parameter
files: 0.76 MB at 1x width, 2.90 MB at 2x (README.md:14-18). This tool
writes the same artifact as the JAX package's exporter, in its format
(codenet_torch/engine/w4a8.py): packed int4 weight levels, per-channel
scales, folded biases and the frozen activation ranges. Serve it with
`python -m codenet_torch.cli.test ... --resume-quantize --int8_infer
--w4a8_artifact <path>`, which gives the checkpoint's int8 detections bit
for bit.

Usage (the flags of codenet_torch.cli.test):
  python tools_torch/export_w4a8.py ctdet --arch shufflenetv2 \\
      --dataset pascal --head_conv 64 --exp_id myexp --resume \\
      --resume-quantize [--w2] [--maxpool] [--gpus -1] [--out path.npz]
  (any task with its own flags: multi_pose --dataset coco_hp, ddd
  --dataset kitti, exdet --dataset coco)

The checkpoint's QAT recipe (bit widths, percentile ranges) is adopted
as the detector adopts it. Runs on the card unless `--gpus -1`.
"""

import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    out = None
    if "--out" in argv:
        i = argv.index("--out")
        out = argv[i + 1]
        del argv[i:i + 2]

    from codenet_torch import config as cfg
    from codenet_torch.engine import checkpoint, w4a8
    from codenet_torch.engine.detector import device_from_opt
    from codenet_torch.models import create_model
    from codenet_torch.models.layers import qspec_from_opt

    opt = cfg.parse(argv)
    opt = cfg.update_dataset_info_and_set_heads(
        opt, cfg.DATASET_SPECS[opt.dataset])
    if not opt.resume_quantize:
        print("ERROR: export requires a QAT checkpoint "
              "(--resume-quantize)", file=sys.stderr)
        return 2
    checkpoint.adopt_quant_recipe(opt, opt.load_model, opt.given_flags)
    opt.int8_infer = True
    model = create_model(opt.arch, opt.heads, opt.head_conv, w2=opt.w2,
                         maxpool=opt.maxpool, qspec=qspec_from_opt(opt),
                         device=device_from_opt(opt))
    checkpoint.load_model(opt.load_model, model)

    out = out or os.path.join(os.path.dirname(opt.load_model),
                              "model_w4a8.npz")
    sizes = w4a8.export_w4a8(model, (opt.input_h, opt.input_w), out)
    print("wrote {}".format(out))
    for k, v in sizes.items():
        print("  {}: {:.1f} KB".format(k, v / 1e3))
    print("W4A8 artifact: {:.3f} MB (reference: 0.76 MB 1x / 2.90 MB 2x)"
          .format(sizes["file_bytes"] / 1e6))
    return 0


if __name__ == "__main__":
    sys.exit(main())
