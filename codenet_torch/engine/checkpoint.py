"""Checkpoints: save, and load with the reference's tolerant semantics.

Reference lib/models/model.py:35-100: strip DataParallel prefixes and load
shape-mismatch-tolerantly with printed warnings. Two formats load:

- a JAX package ``.ckpt``: the pickle of {epoch, variables, opt_state}
  (the JAX package's engine/checkpoint.py:42-60). ``opt_state`` holds optax
  NamedTuples; unpickling those would import optax and then jax, so a
  restricted unpickler maps every class outside numpy to an inert stub,
  and only ``epoch`` and ``variables`` are kept;
- a ``.pth``/``.pt`` (the reference's, or this package's own):
  ``torch.load(weights_only=True)``. A pytorchcv ImageNet ShuffleNetV2
  (``features.*`` keys) is renamed to the reference layout and only its
  backbone (layer0-layer4) loads, so the neck and heads keep their init:
  the JAX package's ImageNet warm start (its engine/torch_import.py::
  convert_pretrained_backbone). A reference checkpoint of CenterNet's
  other backbones whose top-level keys are neither the backbone's nor
  head-shaped raises, as the JAX loader does.

`save_model` writes the port's ``.pth``: {epoch, state_dict[, optimizer,
quant]}, where ``quant`` is the QAT recipe (w_bit, a_bit, percentiles,
act_clamp) that `adopt_quant_recipe` hands to a later quantized load.
In a data-parallel run every rank calls it: the ranks' states are first
checked bit-equal (parallel/mesh.py::check_replicas_equal), then rank 0
writes. Every rank loads the same file.
"""

from __future__ import annotations

import dataclasses
import os
import pickle
import re

import torch

from ..parallel.mesh import barrier, check_replicas_equal
from .jax_weights import from_jax_variables

# numpy globals a pickled array tree needs; anything else becomes a stub
_NUMPY_GLOBALS = {"_reconstruct", "ndarray", "dtype", "scalar",
                  "_frombuffer"}


class _Stub:
    """Inert stand-in for a class the restricted unpickler refuses."""

    def __new__(cls, *args, **kwargs):
        return object.__new__(cls)

    def __init__(self, *args, **kwargs):
        pass

    def __setstate__(self, state):
        pass


class _JaxCkptUnpickler(pickle.Unpickler):
    def find_class(self, module, name):
        root = module.split(".")[0]
        if root == "numpy" and name in _NUMPY_GLOBALS:
            return super().find_class(module, name)
        return type(name, (_Stub,), {"__module__": "stub." + module})


def _contains_stub(tree):
    if isinstance(tree, dict):
        return any(_contains_stub(v) for v in tree.values())
    return isinstance(tree, _Stub)


def read_jax_ckpt(path):
    """(epoch, variables) of a JAX package .ckpt, without importing jax."""
    with open(path, "rb") as f:
        payload = _JaxCkptUnpickler(f).load()
    variables = payload["variables"]
    if _contains_stub(variables):
        raise ValueError("{}: variables hold non-array objects".format(path))
    return int(payload.get("epoch", 0)), variables


def _read_pth(path):
    return torch.load(path, map_location="cpu", weights_only=True)


_GROUPED_UP = re.compile(r"(^|\.)up_\d+\.weight$")


def _shared_up_plane(key, value):
    """A reference DLA checkpoint's grouped up kernel (C, 1, 2f, 2f) ->
    channel 0's plane (1, 1, 2f, 2f): the port, like the JAX package,
    shares one plane across the channels (the JAX package's
    convert_dlav0 keeps channel 0's too)."""
    if _GROUPED_UP.search(key) and value.dim() == 4 \
            and value.shape[1] == 1 and value.shape[0] > 1:
        return value[:1]
    return value


# pytorchcv shufflenetv2_w1/w2 names -> reference CoDeNet names: the JAX
# package's table (the rename the reference built but never applied,
# shufflenetv2_dcn.py:343-361), applied in order to every key
PYTORCHCV_RENAMES = [
    ("features.stage1.", "layer1."), ("features.stage2.", "layer2."),
    ("features.stage3.", "layer3."),
    ("unit1.", "0."), ("unit2.", "1."), ("unit3.", "2."), ("unit4.", "3."),
    ("unit5.", "4."), ("unit6.", "5."), ("unit7.", "6."), ("unit8.", "7."),
    ("compress_layer0", "b2.0"),
    ("dw_conv2", "b2.3"), ("compress_bn1", "b2.1"),
    ("dw_bn2", "b2.4"), ("compress_conv1", "b2.0"),
    ("expand_conv3", "b2.5"), ("expand_bn3", "b2.6"),
    ("dw_conv4", "b1.0"), ("dw_bn4", "b1.1"),
    ("expand_conv5", "b1.2"), ("expand_bn5", "b1.3"),
    ("features.final_block.conv", "layer4.0"),
    ("features.final_block.bn", "layer4.1"),
    ("features.init_block.conv.conv", "layer0.0"),
    ("features.init_block.conv.bn", "layer0.1"),
]

_BACKBONE = ("layer0.", "layer1.", "layer2.", "layer3.", "layer4.")
# what the JAX converter carries of each backbone module: conv weights
# and BN affine parameters and running statistics
_CARRIED = (".weight", ".bias", ".running_mean", ".running_var")


def pytorchcv_to_reference_names(sd):
    """A pytorchcv ShuffleNetV2 state_dict renamed to the reference
    layout (the JAX package's function of the same name), its straggling
    '.conv.weight' suffixes stripped."""
    out = {}
    for key, value in sd.items():
        for old, repl in PYTORCHCV_RENAMES:
            key = key.replace(old, repl)
        out[key.replace(".conv.weight", ".weight")] = value
    return out


def pretrained_backbone(sd):
    """The backbone (layer0-layer4) of a pytorchcv state_dict in the
    reference layout: the entries the JAX package's
    convert_pretrained_backbone converts, and nothing else."""
    return {k: v for k, v in pytorchcv_to_reference_names(sd).items()
            if k.startswith(_BACKBONE) and k.endswith(_CARRIED)}


# the reference layouts whose loader checks the top-level keys (the JAX
# package's _load_torch_payload): a stem key, the backbone's top-level
# modules (the port's dla_34 adds its ida_up) and a head's first weight
# (a conv stack, one conv, or, in the hourglass, one conv stack a stack
# of the network; the JAX check omits the last and so refuses every
# hourglass checkpoint)
_HEAD = ("{}.0.weight", "{}.weight")
_FAMILIES = (
    (("base.base_layer.0.weight",), {"base", "dla_up", "ida_up"}, _HEAD),
    (("pre.0.conv.weight",), {"pre", "kps", "cnvs", "inters", "inters_",
                              "cnvs_"}, _HEAD + ("{}.0.0.conv.weight",)),
    (("deconv_layers.0.weight", "conv1.weight"),
     {"conv1", "bn1", "layer1", "layer2", "layer3", "layer4",
      "deconv_layers"}, _HEAD))


def check_top_level_keys(sd):
    """Raise on a top-level key of a reference DLA, hourglass or ResNet
    state_dict that is neither its backbone's nor head-shaped, with the
    JAX loader's message."""
    for stems, backbone, head in _FAMILIES:
        if not all(k in sd for k in stems):
            continue
        names = sorted({k.split(".")[0] for k in sd} - backbone)
        bogus = [h for h in names
                 if not any(f.format(h) in sd for f in head)]
        if bogus:
            raise ValueError(
                "torch checkpoint has top-level keys that are neither "
                "backbone ({}) nor head-shaped: {} — strip them or pass "
                "a native checkpoint".format(", ".join(sorted(backbone)),
                                             bogus))
        return


def read_checkpoint(path):
    """(epoch, state_dict in the reference layout) from a .ckpt or .pth;
    of a pytorchcv ImageNet .pth, its backbone alone."""
    if path.endswith((".pth", ".pt")):
        payload = _read_pth(path)
        sd = payload.get("state_dict", payload)
        epoch = int(payload.get("epoch", 0)) if "state_dict" in payload \
            else 0
        sd = {k[7:] if k.startswith("module.") else k:
              _shared_up_plane(k, v) for k, v in sd.items()}
        if any(k.startswith("features.") for k in sd):
            return epoch, pretrained_backbone(sd)
        check_top_level_keys(sd)
        return epoch, sd
    epoch, variables = read_jax_ckpt(path)
    return epoch, from_jax_variables(variables)


def load_model(path, model, strict=False):
    """Tolerant load into `model`: keep checkpoint values whose name and
    shape match, warn on mismatches, missing and dropped entries (reference
    model.py:40-69; the JAX package prints the same messages). BN's
    ``num_batches_tracked`` counter has no JAX counterpart and keeps its
    value silently. Returns (model, epoch)."""
    epoch, ckpt = read_checkpoint(path)
    target = model.state_dict()
    out = {}
    for key, tgt in target.items():
        if key in ckpt:
            src = ckpt[key]
            if tuple(src.shape) == tuple(tgt.shape):
                out[key] = src.to(tgt.dtype)
                continue
            msg = ("Skip loading parameter {}, required shape {}, "
                   "loaded shape {}.".format(key, tuple(tgt.shape),
                                              tuple(src.shape)))
        elif key.endswith("num_batches_tracked"):
            out[key] = tgt
            continue
        else:
            msg = "No param {}.".format(key)
        if strict:
            raise ValueError(msg)
        print(msg)
        out[key] = tgt
    for key in ckpt:
        if key not in target:
            msg = "Drop parameter {}.".format(key)
            if strict:
                raise ValueError(msg)
            print(msg)
    model.load_state_dict(out)
    return model, epoch


# QuantSpec fields a checkpoint records and `--resume-quantize` adopts
RECIPE_FIELDS = ("w_bit", "a_bit", "wt_percentile", "act_percentile",
                 "act_clamp")


def save_model(path, epoch, model, optimizer=None, qspec=None, dp=None):
    """Write {epoch, state_dict[, optimizer, quant]} to a .pth (reference
    model.py:91-100), atomically: a crash mid-write never leaves a partial
    model_last. With `dp`: rank 0 writes, once every rank's model is
    bit-equal to it (raises otherwise), and no rank returns before the
    file is there."""
    check_replicas_equal(model, dp)
    if dp is None or dp.main:
        _write(path, epoch, model, optimizer, qspec)
    barrier(dp)


def _write(path, epoch, model, optimizer, qspec):
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    payload = {"epoch": int(epoch),
               "state_dict": {k: v.detach().cpu()
                              for k, v in model.state_dict().items()}}
    if optimizer is not None:
        payload["optimizer"] = optimizer.state_dict()
    if qspec is not None:
        recipe = dataclasses.asdict(qspec)
        payload["quant"] = {k: recipe[k] for k in RECIPE_FIELDS}
    tmp = path + ".tmp"
    torch.save(payload, tmp)
    os.replace(tmp, path)


def adopt_quant_recipe(opt, path, given=()):
    """Set opt's quantization flags that are not in `given` (the options
    the command line gave, config.parse's opt.given_flags) from the recipe
    recorded in a port .pth (a QAT checkpoint evaluated with other flags
    loses accuracy). A flag given on the command line wins, as in the JAX
    package, which runs what its flags say: its synthetic regression
    evaluates a checkpoint trained without --act_clamp with it. Returns
    the recipe, or None when the checkpoint has none."""
    if not path.endswith((".pth", ".pt")):
        return None
    recipe = _read_pth(path).get("quant")
    if not recipe:
        return None
    for key in RECIPE_FIELDS:
        if key not in recipe or getattr(opt, key) == recipe[key]:
            continue
        if key in given:
            print("quant recipe from {}: {} = {}, the flags' {} kept".format(
                path, key, recipe[key], getattr(opt, key)))
            continue
        print("quant recipe from {}: {} = {}".format(path, key, recipe[key]))
        setattr(opt, key, recipe[key])
    return recipe


def resume_lr(base_lr, lr_step, start_epoch):
    """LR after resuming at `start_epoch` (reference model.py:78-84)."""
    lr = base_lr
    for step in lr_step:
        if start_epoch >= step:
            lr *= 0.1
    return lr
