"""PyTorch/CUDA port of codenet-tpu: CoDeNet's four CenterNet tasks, ctdet
(VOC, COCO), multi_pose (COCO keypoints), ddd (KITTI 3D) and exdet
(ExtremeNet, COCO), trained (FP32, then W4A8 QAT) and served (FP32,
fake-quant, or real int8 from a checkpoint or a W4A8 artifact) on an
NVIDIA Hopper card, with hand-written CUDA kernels for
the co-designed deformable convolution's forward and backward
(``ops/deform_cuda.py``, ``csrc/deform_fwd.cu``, ``csrc/deform_bwd.cu``).

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``
(or ``--gpus -1`` on the command line); on ``cuda`` a missing card raises.
"""

import numpy as np
import torch

_CONSTANTS = {}


def device_constant(values, device, dtype=None):
    """`values` (array-like) as a tensor on `device`, made once per
    (values, device, dtype) and kept: a step that a CUDA graph captures
    must copy no host memory to the card, and reads the kept tensor at
    the address it had at capture."""
    arr = np.asarray(values)
    device = torch.device(device)
    key = (arr.tobytes(), arr.shape, arr.dtype.str, str(device), dtype)
    t = _CONSTANTS.get(key)
    if t is None:
        t = torch.as_tensor(arr, device=device)
        if dtype is not None:
            t = t.to(dtype)
        _CONSTANTS[key] = t
    return t


def resolve_device(device="cuda"):
    """torch.device for `device`; a CUDA device without a card raises."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device {} requested but no CUDA card is visible; pass "
            "device='cpu' (--gpus -1) to run on the CPU".format(device))
    return device
