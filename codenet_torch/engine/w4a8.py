"""The W4A8 deployment artifact: capture, pack, save and load.

The reference ships its models as the quantizer's 4-bit parameter files
(0.76 MB at 1x, 2.90 MB at 2x; README.md:14-18). This is the port of the
JAX package's engine/w4a8.py, byte for byte in its format
(``codenet-tpu-w4a8-v1``): an uncompressed ``.npz`` of five blobs and a
JSON manifest that names tensors by their flax path
(engine/jax_weights.py), so either package reads what the other wrote.

- ``q_blob``: per int8 conv of the int8 forward (and per deform kernel),
  its weight levels in HWIO order, two 4-bit levels a byte (low nibble
  first), or one byte each above 4 bits;
- ``s_blob``, ``b_blob``: their per-output-channel f32 scales and folded
  f32 biases;
- ``f_blob``: every params and batch_stats leaf of a module the int8
  forward does not cover (for config a: layer0, which takes the float
  image);
- ``qs_blob``: the frozen activation ranges (quant_stats).

Covered float weights are not shipped: `load_w4a8` leaves the template's,
and the int8 forward never reads them once the artifact's integer weights
are set (models/layers.py, `set_deploy`). `deploy_from_weights` sets a
model's own integer weights the same way, derived once as the exporter
derives them: a checkpoint then serves its artifact's detections.
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch

from ..models.layers import capturing_deploy, set_deploy
from .jax_weights import (from_jax_variables, layout_of_state_dict,
                          module_table, to_jax_variables)

FORMAT = "codenet-tpu-w4a8-v1"


def _flatten(tree, prefix=()):
    """Nested-dict tree -> {('a', 'b', ...): leaf}."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flatten(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = v
    return out


def _unflatten(flat):
    tree = {}
    for path, v in flat.items():
        node = tree
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = v
    return tree


def pack_int4(q):
    """int8 levels in [-8, 7] -> uint8, two per byte (low nibble first)."""
    flat = (np.asarray(q, np.int8).reshape(-1) + 8).astype(np.uint8)
    if flat.size % 2:
        flat = np.concatenate([flat, np.zeros(1, np.uint8)])
    return flat[0::2] | (flat[1::2] << 4)


def unpack_int4(packed, shape):
    n = int(np.prod(shape))
    lo = (packed & 0x0F).astype(np.int16)
    hi = (packed >> 4).astype(np.int16)
    flat = np.empty(packed.size * 2, np.int16)
    flat[0::2] = lo
    flat[1::2] = hi
    return (flat[:n] - 8).astype(np.int8).reshape(shape)


def _port_to_flax(model):
    return {row.port: row.path for row in module_table(
        layout_of_state_dict(model.state_dict()))}


@torch.no_grad()
def capture_deploy(model, input_hw):
    """One int8 forward of `model` (a quantized model with int8_infer) on
    a zero image: {flax path: {"q_w" (HWIO int8), "w_scale", "bias",
    "w_bit"}} numpy, for every conv that runs in int8 and every deform
    kernel, as the forward derives them from the float weights."""
    device = next(model.parameters()).device
    with capturing_deploy(model) as sink:
        model(torch.zeros(1, input_hw[0], input_hw[1], 3, device=device))
    names = {m: n for n, m in model.named_modules()}
    to_flax = _port_to_flax(model)
    out = {}
    for mod, entry in sink.items():
        bias = entry["bias"]
        out[to_flax[names[mod]]] = {
            "q_w": np.transpose(entry["q_w"].cpu().numpy(), (2, 3, 1, 0)),
            "w_scale": entry["w_scale"].float().cpu().numpy(),
            "bias": (np.zeros(0, np.float32) if bias is None
                     else bias.detach().float().cpu().numpy()),
            "w_bit": entry["w_bit"]}
    return out


def _set_deploy(model, convs):
    """`set_deploy` on each module of {flax path: {"q_w" (HWIO int8),
    "w_scale", "bias" (size 0 for none)}}, on the model's device."""
    by_path = {v: k for k, v in _port_to_flax(model).items()}
    device = next(model.parameters()).device

    def tensor(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)
    for path, entry in convs.items():
        set_deploy(model.get_submodule(by_path[path]),
                   tensor(np.transpose(entry["q_w"], (3, 2, 0, 1))),
                   tensor(entry["w_scale"]),
                   tensor(entry["bias"]) if entry["bias"].size else None)


def deploy_from_weights(model, input_hw):
    """Derive `model`'s integer weights once (`capture_deploy`) and set
    them as `load_w4a8` sets an artifact's: its int8 forwards then skip
    the per-call fold and quantization and give the detections of its
    artifact. Returns the model."""
    _set_deploy(model, capture_deploy(model, input_hw))
    return model


def export_w4a8(model, input_hw, path):
    """Write the packed artifact of `model` (int8_infer, weights and
    ranges loaded). Returns the size breakdown in bytes."""
    convs = capture_deploy(model, input_hw)
    manifest = {"convs": [], "floats": [], "quant_stats": [],
                "format": FORMAT}
    # one blob per kind: a zip entry costs ~1 KB, ~90 of them would dwarf
    # the packed weights
    q_parts, s_parts, b_parts = [], [], []
    for p, entry in sorted(convs.items()):
        q_w = entry["q_w"].astype(np.int8)
        wb = int(entry["w_bit"])
        packed = pack_int4(q_w) if wb <= 4 \
            else q_w.reshape(-1).view(np.uint8)
        manifest["convs"].append(
            {"path": list(p), "shape": list(q_w.shape), "w_bit": wb,
             "q_bytes": int(packed.nbytes),
             "n_bias": int(entry["bias"].size)})
        q_parts.append(packed)
        s_parts.append(entry["w_scale"].astype(np.float32))
        b_parts.append(entry["bias"].astype(np.float32))

    variables = to_jax_variables(model.state_dict())
    f_parts = []
    for coll in ("params", "batch_stats"):
        for p, v in sorted(_flatten(variables[coll]).items()):
            if p[:-1] in convs:
                continue
            a = np.asarray(v, np.float32)
            manifest["floats"].append(
                {"path": list(p), "coll": coll, "shape": list(a.shape)})
            f_parts.append(a.reshape(-1))
    qs_parts = []
    for p, v in sorted(_flatten(variables.get("quant_stats", {})).items()):
        a = np.asarray(v, np.float32)
        manifest["quant_stats"].append(
            {"path": list(p), "shape": list(a.shape)})
        qs_parts.append(a.reshape(-1))

    def cat(parts, dtype):
        return np.concatenate(parts).astype(dtype) if parts \
            else np.zeros(0, dtype)
    arrays = {
        "q_blob": cat(q_parts, np.uint8),
        "s_blob": cat(s_parts, np.float32),
        "b_blob": cat(b_parts, np.float32),
        "f_blob": cat(f_parts, np.float32),
        "qs_blob": cat(qs_parts, np.float32),
        "manifest": np.frombuffer(json.dumps(manifest).encode(), np.uint8),
    }
    # uncompressed: the file's size is the packed size
    np.savez(path, **arrays)
    return {"int4_weights": int(arrays["q_blob"].nbytes),
            "scales_biases": int(arrays["s_blob"].nbytes
                                 + arrays["b_blob"].nbytes),
            "float_leaves": int(arrays["f_blob"].nbytes),
            "quant_stats": int(arrays["qs_blob"].nbytes),
            "file_bytes": os.path.getsize(path)}


@torch.no_grad()
def load_w4a8(path, model):
    """Load the artifact at `path` into `model` (a template of the
    exported configuration with int8_infer, on its device): the shipped
    float leaves and ranges into its state, the integer weights onto its
    convs and deform weight holders (`set_deploy`). Covered float weights
    keep the template's values. Returns the model."""
    with np.load(path) as z:
        arrays = {k: z[k] for k in z.files}
    manifest = json.loads(bytes(arrays["manifest"].tobytes()).decode())
    if manifest.get("format") != FORMAT:
        raise ValueError("{}: not a codenet-tpu W4A8 artifact".format(path))

    variables = {coll: _flatten(tree) for coll, tree in
                 to_jax_variables(model.state_dict()).items()}
    fo = 0
    for f in manifest["floats"]:
        n = int(np.prod(f["shape"])) if f["shape"] else 1
        variables[f["coll"]][tuple(f["path"])] = \
            arrays["f_blob"][fo:fo + n].reshape(f["shape"])
        fo += n
    qso = 0
    for q in manifest["quant_stats"]:
        n = int(np.prod(q["shape"])) if q["shape"] else 1
        variables["quant_stats"][tuple(q["path"])] = \
            arrays["qs_blob"][qso:qso + n].reshape(q["shape"])
        qso += n
    model.load_state_dict(from_jax_variables(
        {coll: _unflatten(flat) for coll, flat in variables.items()}))

    convs = {}
    qo = so = bo = 0
    for c in manifest["convs"]:
        shape = tuple(c["shape"])
        raw = arrays["q_blob"][qo:qo + c["q_bytes"]]
        qo += c["q_bytes"]
        q_w = unpack_int4(raw, shape) if c["w_bit"] <= 4 \
            else raw.view(np.int8).reshape(shape)
        convs[tuple(c["path"])] = {
            "q_w": q_w, "w_scale": arrays["s_blob"][so:so + shape[-1]],
            "bias": arrays["b_blob"][bo:bo + c["n_bias"]]}
        so += shape[-1]
        bo += c["n_bias"]
    _set_deploy(model, convs)
    return model
