"""PyTorch/CUDA port of codenet-tpu: CoDeNet's ctdet detector served on an
NVIDIA Hopper card, with a hand-written CUDA kernel for the co-designed
deformable convolution (``ops/deform_cuda.py``, ``csrc/deform_fwd.cu``).

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``
(or ``--gpus -1`` on the command line); on ``cuda`` a missing card raises.
"""

import torch


def resolve_device(device="cuda"):
    """torch.device for `device`; a CUDA device without a card raises."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device {} requested but no CUDA card is visible; pass "
            "device='cpu' (--gpus -1) to run on the CPU".format(device))
    return device
