"""PyTorch/CUDA port of codenet-tpu: CoDeNet's four CenterNet tasks, ctdet
(VOC, COCO), multi_pose (COCO keypoints), ddd (KITTI 3D) and exdet
(ExtremeNet, COCO), trained (FP32, then W4A8 QAT) and served (FP32 or
fake-quant; ctdet also in real int8, from a checkpoint or a W4A8
artifact) on an NVIDIA Hopper card, with hand-written CUDA kernels for
the co-designed deformable convolution's forward and backward
(``ops/deform_cuda.py``, ``csrc/deform_fwd.cu``, ``csrc/deform_bwd.cu``).

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
