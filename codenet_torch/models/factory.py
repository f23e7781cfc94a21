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
_DTYPES = {None: None, "float32": None, torch.float32: None,
           "bfloat16": torch.bfloat16, torch.bfloat16: torch.bfloat16}


def compute_dtype(dtype):
    """The model's compute dtype for a `--dtype` value or a torch dtype:
    None (f32) or torch.bfloat16."""
    if dtype not in _DTYPES:
        raise ValueError("dtype must be float32 or bfloat16, got "
                         "{}".format(dtype))
    return _DTYPES[dtype]


def create_model(arch, heads, head_conv, w2=False, maxpool=False,
                 deform_backbone=False, qspec=None, dtype=None,
                 device="cuda", generator=None):
    """Build an eval-mode model on `device` (channels_last), its weights
    drawn from `generator` (default: seeded 0); `qspec` (a QuantSpec)
    selects W4A8 fake-quant execution, or real int8 with `int8_infer`.

    dtype, the compute dtype of the convs (the JAX ``--dtype``): None,
    "float32" or torch.float32 for f32; "bfloat16" or torch.bfloat16 for
    bf16. Parameters and buffers are f32 either way.
    """
    num_layers = int(arch[arch.find("_") + 1:]) if "_" in arch else 0
    arch_name = arch[:arch.find("_")] if "_" in arch else arch
    if arch_name not in MODEL_FACTORY:
        raise NotImplementedError(
            "arch {} is not ported yet (ROADMAP.md); codenet_torch has: "
            "{}".format(arch, sorted(MODEL_FACTORY)))
    device = resolve_device(device)
    model = MODEL_FACTORY[arch_name](num_layers, heads, head_conv, w2=w2,
                                     maxpool=maxpool,
                                     deform_backbone=deform_backbone,
                                     qspec=qspec,
                                     dtype=compute_dtype(dtype))
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    model.reset_parameters(generator)
    return model.to(device, memory_format=torch.channels_last).eval()
