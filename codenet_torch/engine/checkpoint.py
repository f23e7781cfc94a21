"""Checkpoint loading with the reference's tolerant semantics.

Reference lib/models/model.py:35-69: strip DataParallel prefixes and load
shape-mismatch-tolerantly with printed warnings. Two formats:

- a JAX package ``.ckpt``: the pickle of {epoch, variables, opt_state}
  (the JAX package's engine/checkpoint.py:42-60). ``opt_state`` holds optax
  NamedTuples; unpickling those would import optax and then jax, so a
  restricted unpickler maps every class outside numpy to an inert stub,
  and only ``epoch`` and ``variables`` are kept;
- a reference ``.pth``/``.pt``: ``torch.load(weights_only=True)``.
"""

from __future__ import annotations

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


def read_checkpoint(path):
    """(epoch, state_dict in the reference layout) from a .ckpt or .pth."""
    if path.endswith((".pth", ".pt")):
        payload = torch.load(path, map_location="cpu", weights_only=True)
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
