"""QAT training CLI (the JAX package's cli/quant_main.py; reference
quant_main.py:19-113).

Loads an FP32 checkpoint into the same module tree in W4A8 fake-quant
execution (BN folded and frozen, weights fake-quantized, activation ranges
tracked by EMA), fine-tunes with straight-through gradients, and, for
ctdet, ends with a fake-quant detection eval of the result.

    python -m codenet_torch.cli.quant_main ctdet --dataset pascal \\
        --arch shufflenetv2 --input_res 256 --batch_size 32 \\
        --load_model exp/ctdet/<fp32 exp_id>/model_last.pth [--gpus -1]
"""

from __future__ import annotations

from .. import config as cfg
from ..models.layers import qspec_from_opt
from .main import run_training


def main(argv=None):
    opt = cfg.parse(argv)
    return run_training(opt, qspec=qspec_from_opt(opt))


if __name__ == "__main__":
    main()
