"""Weights carried across from and to the JAX package.

One table (`module_table`) pairs each port module with its flax path in
the JAX PoseShuffleNetV2, e.g. ``layer1.0.b2.0`` + ``layer1.0.b2.1`` with
('layer1', 'node0', 'b2_conv1'), ``deconv_layers.0.conv`` with ('deconv0',)
(its ``deform_kernel``), ``hm.6`` with ('head_hm', 'out') and
``layer1.share_act`` with ('layer1', 'share_act'). Both directions read
it:

- `from_jax_variables` turns the JAX model's ``{'params', 'batch_stats'}``
  numpy trees (as saved in a ``.ckpt``) into this package's
  ``state_dict``: HWIO -> OIHW kernels, BN ``scale/bias`` + ``mean/var``
  -> ``weight/bias/running_mean/running_var``, and a ``quant_stats`` tree
  (the QAT activation ranges) onto the ``QuantAct`` buffers. It is the
  inverse of the JAX package's engine/torch_import.py::
  convert_shufflenetv2 and produces the reference CoDeNet key layout;
- `to_jax_variables` is its inverse, for the W4A8 artifact, whose
  manifest names tensors by flax path (engine/w4a8.py).
"""

from __future__ import annotations

import re
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch


def quant_stats_name(path):
    """Port module name of a JAX ``quant_stats`` node path, e.g.
    ('layer1', 'node0', 'b2_act1') -> 'layer1.0.b2_act1',
    ('deconv2', 'scale_act') -> 'deconv_layers.8.scale_act',
    ('head_hm', 'act1') -> 'hm.act1'; top-level acts keep their name."""
    out = []
    for i, key in enumerate(path):
        inner = i < len(path) - 1
        node = re.fullmatch(r"node(\d+)", key)
        deconv = re.fullmatch(r"deconv(\d+)", key)
        if node:
            out.append(node.group(1))
        elif deconv and inner:
            out.append("deconv_layers.{}".format(4 * int(deconv.group(1))))
        elif key.startswith("head_") and inner:
            out.append(key[5:])
        else:
            out.append(key)
    return ".".join(out)


class Row(NamedTuple):
    """One module pair. kind: 'conv_bn' (port conv + BN `bn`; flax ConvBN
    kernel/scale/bias + mean/var), 'conv' (kernel, bias), 'deform' (the
    block's ``deform_kernel`` leaf), 'bn' (a BatchNorm) or 'act' (a
    QuantAct's x_min/x_max)."""
    kind: str
    port: str
    path: Tuple[str, ...]
    bn: Optional[str] = None


class Layout(NamedTuple):
    """What the table depends on: nodes per stage, whether each deconv
    block has a mixer, and the heads' names."""
    stages: Tuple[int, ...]
    mixers: Tuple[bool, ...]
    heads: Tuple[str, ...]


def layout_of_jax(params):
    nodes = [sum(k.startswith("node") for k in params["layer{}".format(s)])
             for s in (1, 2, 3)]
    mixers = []
    while "deconv{}".format(len(mixers)) in params:
        mixers.append("conv_channel" in params["deconv{}".format(
            len(mixers))])
    return Layout(tuple(nodes), tuple(mixers),
                  tuple(sorted(k[5:] for k in params if k.startswith(
                      "head_"))))


def layout_of_state_dict(sd):
    nodes = [len({k.split(".")[1] for k in sd
                  if re.match(r"layer{}\.\d+\.".format(s), k)})
             for s in (1, 2, 3)]
    mixers = []
    while "deconv_layers.{}.conv.weight".format(4 * len(mixers)) in sd:
        mixers.append("deconv_layers.{}.conv_channel.weight".format(
            4 * len(mixers)) in sd)
    heads = sorted(k[:-len(".6.bias")] for k in sd
                   if re.fullmatch(r"[^.]+\.6\.bias", k))
    return Layout(tuple(nodes), tuple(mixers), tuple(heads))


def module_table(layout):
    """Every Row of a PoseShuffleNetV2 of `layout`, activation quantizers
    included (named as `quant_stats_name` maps their flax paths)."""
    rows = []

    def conv_bn(port, bn, path):
        rows.append(Row("conv_bn", port, path, bn))

    def act(*path):
        rows.append(Row("act", quant_stats_name(path), path))

    conv_bn("layer0.0", "layer0.1", ("layer0",))
    act("layer0_act")
    for stage, nodes in enumerate(layout.stages, 1):
        layer = "layer{}".format(stage)
        for k in range(nodes):
            base, path = "{}.{}".format(layer, k), (layer, "node{}".format(k))
            if k == 0:
                conv_bn(base + ".b1.0", base + ".b1.1", path + ("b1_conv1",))
                conv_bn(base + ".b1.2", base + ".b1.3", path + ("b1_conv2",))
                act(*path, "b1_act1")
            conv_bn(base + ".b2.0", base + ".b2.1", path + ("b2_conv1",))
            conv_bn(base + ".b2.3", base + ".b2.4", path + ("b2_conv2",))
            conv_bn(base + ".b2.5", base + ".b2.6", path + ("b2_conv3",))
            act(*path, "b2_act1")
            act(*path, "b2_act2")
        act(layer, "share_act")
    conv_bn("layer4.0", "layer4.1", ("layer4",))
    act("layer4_act")
    for i, mixer in enumerate(layout.mixers):
        name = "deconv{}".format(i)
        base = "deconv_layers.{}".format(4 * i)
        bn = "deconv_layers.{}".format(4 * i + 1)
        rows.append(Row("conv", base + ".conv_scale", (name, "conv_scale")))
        rows.append(Row("deform", base + ".conv", (name,)))
        if mixer:
            conv_bn(base + ".conv_channel", bn, (name, "conv_channel"))
        else:
            rows.append(Row("bn", bn, (name, "bn")))
        act(name, "scale_act")
        act(name, "deform_act")
        act(name + "_act")
    for head in layout.heads:
        path = ("head_" + head,)
        conv_bn(head + ".0", head + ".1", path + ("conv1",))
        conv_bn(head + ".3", head + ".4", path + ("conv2",))
        rows.append(Row("conv", head + ".6", path + ("out",)))
        act(*path, "act1")
        act(*path, "act2")
    return rows


def _leaves(tree, path=()):
    for key, value in tree.items():
        if isinstance(value, dict):
            yield from _leaves(value, path + (key,))
        else:
            yield path + (key,), value


def hwio_to_oihw(kernel):
    return np.transpose(np.asarray(kernel, np.float32), (3, 2, 0, 1))


def oihw_to_hwio(weight):
    return np.ascontiguousarray(np.transpose(weight, (2, 3, 1, 0)))


def from_jax_variables(variables):
    """{'params': ..., 'batch_stats': ...[, 'quant_stats': ...]} ->
    {name: float32 tensor}."""
    params = variables["params"]
    stats = variables.get("batch_stats", {})
    sd = {}

    def node(tree, path):
        for k in path:
            tree = tree[k]
        return tree

    def bn(key, path):
        p, s = node(params, path), node(stats, path)
        sd[key + ".weight"] = p["scale"]
        sd[key + ".bias"] = p["bias"]
        sd[key + ".running_mean"] = s["mean"]
        sd[key + ".running_var"] = s["var"]

    for row in module_table(layout_of_jax(params)):
        if row.kind in ("conv_bn", "conv"):
            p = node(params, row.path)
            sd[row.port + ".weight"] = hwio_to_oihw(p["kernel"])
            if row.kind == "conv":
                sd[row.port + ".bias"] = p["bias"]
            else:
                bn(row.bn, row.path)
        elif row.kind == "deform":
            sd[row.port + ".weight"] = hwio_to_oihw(
                node(params, row.path)["deform_kernel"])
        elif row.kind == "bn":
            bn(row.port, row.path)

    for path, value in _leaves(variables.get("quant_stats", {})):
        sd[quant_stats_name(path[:-1]) + "." + path[-1]] = value

    return {k: torch.from_numpy(np.array(v, dtype=np.float32))
            for k, v in sd.items()}


def to_jax_variables(state_dict):
    """This package's ``state_dict`` -> the JAX model's {'params',
    'batch_stats', 'quant_stats'} numpy f32 trees (quant_stats only where
    the model has quantizers)."""
    sd = {k: v.detach().float().cpu().numpy() for k, v in state_dict.items()}
    out = {"params": {}, "batch_stats": {}, "quant_stats": {}}

    def put(coll, path, **leaves):
        tree = out[coll]
        for k in path:
            tree = tree.setdefault(k, {})
        tree.update(leaves)

    def bn(key, path):
        put("params", path, scale=sd[key + ".weight"],
            bias=sd[key + ".bias"])
        put("batch_stats", path, mean=sd[key + ".running_mean"],
            var=sd[key + ".running_var"])

    for row in module_table(layout_of_state_dict(sd)):
        if row.kind in ("conv_bn", "conv"):
            put("params", row.path,
                kernel=oihw_to_hwio(sd[row.port + ".weight"]))
            if row.kind == "conv":
                put("params", row.path, bias=sd[row.port + ".bias"])
            else:
                bn(row.bn, row.path)
        elif row.kind == "deform":
            put("params", row.path,
                deform_kernel=oihw_to_hwio(sd[row.port + ".weight"]))
        elif row.kind == "bn":
            bn(row.port, row.path)
        elif row.port + ".x_min" in sd:
            put("quant_stats", row.path, x_min=sd[row.port + ".x_min"],
                x_max=sd[row.port + ".x_max"])
    if not out["quant_stats"]:
        del out["quant_stats"]
    return out
