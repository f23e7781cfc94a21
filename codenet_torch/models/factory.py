"""Model factory (reference lib/models/model.py:17-32).

arch strings are '<name>_<num_layers>' (e.g. 'res_18', 'shufflenetv2'); the
numeric suffix is split off exactly as the reference does. The six arch
families of the JAX package's factory: shufflenetv2 (CoDeNet), res,
resdcn, dla (DLA-34 with DCNv2 up path, the CLIs' default dla_34), dlav0
and hourglass. Only shufflenetv2 quantizes, takes bf16 operands and has
the w2 / maxpool / deform-backbone variants; the others warn on a
QuantSpec and run f32 convs, as in the JAX package.
"""

from __future__ import annotations

import torch

from .. import resolve_device
from . import dla_dcn, dlav0, hourglass, resnet
from .shufflenetv2 import get_shufflenetv2_dcn

# the getters carry the JAX package's head_conv defaults (256 for the DLA
# networks, 64 for the others)
MODEL_FACTORY = {
    "res": resnet.get_pose_net,
    "resdcn": resnet.get_pose_net_dcn,
    "dla": dla_dcn.get_pose_net,
    "dlav0": dlav0.get_pose_net,
    "hourglass": hourglass.get_large_hourglass_net,
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
    selects W4A8 fake-quant execution, or real int8 with `int8_infer`
    (shufflenetv2 only). w2, maxpool and deform_backbone are read for
    shufflenetv2 only, as the JAX package's create_model reads w2 and
    maxpool.

    dtype, the compute dtype of the convs (the JAX ``--dtype``): None,
    "float32" or torch.float32 for f32; "bfloat16" or torch.bfloat16 for
    bf16. Parameters and buffers are f32 either way.
    """
    num_layers = int(arch[arch.find("_") + 1:]) if "_" in arch else 0
    arch_name = arch[:arch.find("_")] if "_" in arch else arch
    if arch_name not in MODEL_FACTORY:
        raise ValueError("unknown arch {}; codenet_torch has: {}".format(
            arch, sorted(MODEL_FACTORY)))
    device = resolve_device(device)
    kwargs = dict(qspec=qspec, dtype=compute_dtype(dtype))
    if arch_name == "shufflenetv2":
        kwargs.update(w2=w2, maxpool=maxpool,
                      deform_backbone=deform_backbone)
    model = MODEL_FACTORY[arch_name](num_layers, heads, head_conv, **kwargs)
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    model.reset_parameters(generator)
    return model.to(device, memory_format=torch.channels_last).eval()
