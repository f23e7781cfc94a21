"""Checkpoints: save, and load with the reference's tolerant semantics.

Reference lib/models/model.py:35-100: strip DataParallel prefixes and load
shape-mismatch-tolerantly with printed warnings. Two formats load:

- a JAX package ``.ckpt``: the pickle of {epoch, variables, opt_state}
  (the JAX package's engine/checkpoint.py:42-60). ``opt_state`` holds optax
  NamedTuples; unpickling those would import optax and then jax, so a
  restricted unpickler maps every class outside numpy to an inert stub,
  and only ``epoch`` and ``variables`` are kept;
- a ``.pth``/``.pt`` (the reference's, or this package's own):
  ``torch.load(weights_only=True)``.

`save_model` writes the port's ``.pth``: {epoch, state_dict[, optimizer,
quant]}, where ``quant`` is the QAT recipe (w_bit, a_bit, percentiles,
act_clamp) that `adopt_quant_recipe` hands to a later quantized load.
"""

from __future__ import annotations

import dataclasses
import os
import pickle

import torch

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


def read_checkpoint(path):
    """(epoch, state_dict in the reference layout) from a .ckpt or .pth."""
    if path.endswith((".pth", ".pt")):
        payload = _read_pth(path)
        sd = payload.get("state_dict", payload)
        epoch = int(payload.get("epoch", 0)) if "state_dict" in payload \
            else 0
        sd = {k[7:] if k.startswith("module.") else k: v
              for k, v in sd.items()}
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


def save_model(path, epoch, model, optimizer=None, qspec=None):
    """Write {epoch, state_dict[, optimizer, quant]} to a .pth (reference
    model.py:91-100), atomically: a crash mid-write never leaves a partial
    model_last."""
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


def adopt_quant_recipe(opt, path):
    """Set opt's quantization flags from the recipe recorded in a port
    .pth (a QAT checkpoint evaluated with other flags loses accuracy);
    returns the recipe, or None when the checkpoint has none."""
    if not path.endswith((".pth", ".pt")):
        return None
    recipe = _read_pth(path).get("quant")
    if not recipe:
        return None
    for key in RECIPE_FIELDS:
        if key in recipe and getattr(opt, key, None) != recipe[key]:
            print("quant recipe from {}: {} = {}".format(path, key,
                                                        recipe[key]))
            setattr(opt, key, recipe[key])
    return recipe


def resume_lr(base_lr, lr_step, start_epoch):
    """LR after resuming at `start_epoch` (reference model.py:78-84)."""
    lr = base_lr
    for step in lr_step:
        if start_epoch >= step:
            lr *= 0.1
    return lr
