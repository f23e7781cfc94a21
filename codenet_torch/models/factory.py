"""Model factory (reference lib/models/model.py:17-32).

arch strings are '<name>_<num_layers>' (e.g. 'res_18', 'shufflenetv2'); the
numeric suffix is split off exactly as the reference does. Only
ShuffleNetV2-DCN is ported so far; the other arches are queued in
ROADMAP.md.
"""

from __future__ import annotations

import torch

from .. import resolve_device
from .shufflenetv2 import get_shufflenetv2_dcn

MODEL_FACTORY = {
    "shufflenetv2": get_shufflenetv2_dcn,
}


def create_model(arch, heads, head_conv, w2=False, maxpool=False, qspec=None,
                 dtype=None, device="cuda", generator=None):
    """Build an eval-mode model on `device` (channels_last), its weights
    drawn from `generator` (default: seeded 0); `qspec` (a QuantSpec)
    selects W4A8 fake-quant execution.

    dtype None or float32 only: the bf16 model path is queued in
    ROADMAP.md.
    """
    num_layers = int(arch[arch.find("_") + 1:]) if "_" in arch else 0
    arch_name = arch[:arch.find("_")] if "_" in arch else arch
    if arch_name not in MODEL_FACTORY:
        raise NotImplementedError(
            "arch {} is not ported yet (ROADMAP.md); codenet_torch has: "
            "{}".format(arch, sorted(MODEL_FACTORY)))
    if dtype not in (None, torch.float32, "float32"):
        raise NotImplementedError(
            "dtype {} is queued in ROADMAP.md; the served model is "
            "FP32".format(dtype))
    device = resolve_device(device)
    model = MODEL_FACTORY[arch_name](num_layers, heads, head_conv, w2=w2,
                                     maxpool=maxpool, qspec=qspec)
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    model.reset_parameters(generator)
    return model.to(device, memory_format=torch.channels_last).eval()
