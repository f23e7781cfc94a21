"""Weights carried across from the JAX package.

`from_jax_variables` turns the JAX model's ``{'params', 'batch_stats'}``
numpy trees (PoseShuffleNetV2, as saved in a ``.ckpt``) into this
package's ``state_dict``: HWIO -> OIHW kernels, BN ``scale/bias`` +
``mean/var`` -> ``weight/bias/running_mean/running_var``. It is the
inverse of the JAX package's engine/torch_import.py::convert_shufflenetv2,
and produces the reference CoDeNet key layout. A ``quant_stats`` tree (the
QAT activation ranges) maps onto the quantized model's ``QuantAct``
buffers (`quant_stats_name`).
"""

from __future__ import annotations

import re

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


def _leaves(tree, path=()):
    for key, value in tree.items():
        if isinstance(value, dict):
            yield from _leaves(value, path + (key,))
        else:
            yield path + (key,), value


def hwio_to_oihw(kernel):
    return np.transpose(np.asarray(kernel, np.float32), (3, 2, 0, 1))


def from_jax_variables(variables):
    """{'params': ..., 'batch_stats': ...} -> {name: float32 tensor}."""
    params = variables["params"]
    stats = variables.get("batch_stats", {})
    sd = {}

    def node(tree, path):
        for k in path:
            tree = tree[k]
        return tree

    def conv(key, path, bias=False):
        p = node(params, path)
        sd[key + ".weight"] = hwio_to_oihw(p["kernel"])
        if bias:
            sd[key + ".bias"] = p["bias"]

    def bn(key, path):
        p, s = node(params, path), node(stats, path)
        sd[key + ".weight"] = p["scale"]
        sd[key + ".bias"] = p["bias"]
        sd[key + ".running_mean"] = s["mean"]
        sd[key + ".running_var"] = s["var"]

    def conv_bn(conv_key, bn_key, path):
        conv(conv_key, path)
        bn(bn_key, path)

    conv_bn("layer0.0", "layer0.1", ["layer0"])
    for stage in (1, 2, 3):
        nodes = params["layer{}".format(stage)]
        k = 0
        while "node{}".format(k) in nodes:
            base = "layer{}.{}".format(stage, k)
            path = ["layer{}".format(stage), "node{}".format(k)]
            if "b1_conv1" in nodes["node{}".format(k)]:
                conv_bn(base + ".b1.0", base + ".b1.1", path + ["b1_conv1"])
                conv_bn(base + ".b1.2", base + ".b1.3", path + ["b1_conv2"])
            conv_bn(base + ".b2.0", base + ".b2.1", path + ["b2_conv1"])
            conv_bn(base + ".b2.3", base + ".b2.4", path + ["b2_conv2"])
            conv_bn(base + ".b2.5", base + ".b2.6", path + ["b2_conv3"])
            k += 1
    conv_bn("layer4.0", "layer4.1", ["layer4"])

    i = 0
    while "deconv{}".format(i) in params:
        name = "deconv{}".format(i)
        base = "deconv_layers.{}".format(4 * i)
        conv(base + ".conv_scale", [name, "conv_scale"], bias=True)
        sd[base + ".conv.weight"] = hwio_to_oihw(params[name]["deform_kernel"])
        if "conv_channel" in params[name]:
            conv_bn(base + ".conv_channel", "deconv_layers.{}".format(4 * i + 1),
                    [name, "conv_channel"])
        else:
            bn("deconv_layers.{}".format(4 * i + 1), [name, "bn"])
        i += 1

    for head in sorted(k[5:] for k in params if k.startswith("head_")):
        path = ["head_" + head]
        conv_bn(head + ".0", head + ".1", path + ["conv1"])
        conv_bn(head + ".3", head + ".4", path + ["conv2"])
        conv(head + ".6", path + ["out"], bias=True)

    for path, value in _leaves(variables.get("quant_stats", {})):
        sd[quant_stats_name(path[:-1]) + "." + path[-1]] = value

    return {k: torch.from_numpy(np.array(v, dtype=np.float32))
            for k, v in sd.items()}
