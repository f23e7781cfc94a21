"""Weights carried across from and to the JAX package.

One table (`module_table`) pairs each port module with its flax path in
the JAX PoseShuffleNetV2, e.g. ``layer1.0.b2.0`` + ``layer1.0.b2.1`` with
('layer1', 'node0', 'b2_conv1'), ``deconv_layers.0.conv`` with ('deconv0',)
(its ``deform_kernel``), ``hm.6`` with ('head_hm', 'out') and
``layer1.share_act`` with ('layer1', 'share_act'); with the deform
backbone ``layer1.1.b2.3`` (its ``conv_scale``, ``conv`` and
quantizers) with ('layer1', 'node1', 'b2_conv2') and its closing BN
``layer1.1.b2.4`` with ('layer1', 'node1', 'b2_conv2', 'bn'), and
``layerL.0.b1.{0,1}`` with ('layerL', 'node0', 'b1_conv1') likewise. Both
directions read it:

- `from_jax_variables` turns the JAX model's ``{'params', 'batch_stats'}``
  numpy trees (as saved in a ``.ckpt``) into this package's
  ``state_dict``: HWIO -> OIHW kernels, BN ``scale/bias`` + ``mean/var``
  -> ``weight/bias/running_mean/running_var``, and a ``quant_stats`` tree
  (the QAT activation ranges) onto the ``QuantAct`` buffers. It is the
  inverse of the JAX package's engine/torch_import.py::
  convert_shufflenetv2 and produces the reference CoDeNet key layout;
- `to_jax_variables` is its inverse, for the W4A8 artifact, whose
  manifest names tensors by flax path (engine/w4a8.py).

The five other arch families (res, resdcn, dlav0, dla, hourglass) are
mapped by name instead: `flax_target` turns each port module name into
its flax path (e.g. ``layer1.0.conv2`` -> ('layer1_0', 'Conv_1'),
``base.level3.tree1.root.bn`` -> ('level3', 'tree1', 'root', 'bn'),
``dla_up.ida_2.node_1.conv`` -> ('ida_2', 'node_1', 'conv'),
``kps.0.low2.low1.1.skip.0`` -> ('kp0', 'low2', 'low1', 'res1',
'skip_conv'), ``hm.1.0.conv`` -> ('hm1_conv', 'Conv_0')). Both directions
walk the port's ``state_dict`` keys: `to_jax_variables` those it is
given, `from_jax_variables` those of the network the flax tree describes
(built on the meta device: names and shapes only). Each family is told
apart by its stem, as the JAX package's engine/checkpoint.py:97-128
tells the reference ``state_dict``s apart.
"""

from __future__ import annotations

import re
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch


# a deform backbone block's flax name -> its port module (BaseNode.b1/b2)
_DEFORM_NODES = {"b1_conv1": "b1.0", "b2_conv2": "b2.3"}


def quant_stats_name(path):
    """Port module name of a JAX ``quant_stats`` node path, e.g.
    ('layer1', 'node0', 'b2_act1') -> 'layer1.0.b2_act1',
    ('deconv2', 'scale_act') -> 'deconv_layers.8.scale_act',
    ('layer1', 'node1', 'b2_conv2', 'scale_act') ->
    'layer1.1.b2.3.scale_act', ('head_hm', 'act1') -> 'hm.act1';
    top-level acts keep their name."""
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
        elif key in _DEFORM_NODES and inner:
            out.append(_DEFORM_NODES[key])
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
    block has a mixer, the heads' names, and whether the backbone's
    depthwise 3x3s are deform blocks (deform_backbone)."""
    stages: Tuple[int, ...]
    mixers: Tuple[bool, ...]
    heads: Tuple[str, ...]
    deform: bool = False


def layout_of_jax(params):
    nodes = [sum(k.startswith("node") for k in params["layer{}".format(s)])
             for s in (1, 2, 3)]
    mixers = []
    while "deconv{}".format(len(mixers)) in params:
        mixers.append("conv_channel" in params["deconv{}".format(
            len(mixers))])
    return Layout(tuple(nodes), tuple(mixers),
                  tuple(sorted(k[5:] for k in params if k.startswith(
                      "head_"))),
                  "conv_scale" in params["layer1"]["node0"]["b2_conv2"])


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
    return Layout(tuple(nodes), tuple(mixers), tuple(heads),
                  "layer1.0.b2.3.conv_scale.weight" in sd)


def module_table(layout):
    """Every Row of a PoseShuffleNetV2 of `layout`, activation quantizers
    included (named as `quant_stats_name` maps their flax paths)."""
    rows = []

    def conv_bn(port, bn, path):
        rows.append(Row("conv_bn", port, path, bn))

    def act(*path):
        rows.append(Row("act", quant_stats_name(path), path))

    def deform_block(port, bn, path, mixer=False):
        """A co-designed deform block: its scale predictor and deform
        kernel, then its mixer + BN `bn` or the BN `bn` that closes it,
        then its quantizers."""
        rows.append(Row("conv", port + ".conv_scale", path + ("conv_scale",)))
        rows.append(Row("deform", port + ".conv", path))
        if mixer:
            conv_bn(port + ".conv_channel", bn, path + ("conv_channel",))
        else:
            rows.append(Row("bn", bn, path + ("bn",)))
        act(*path, "scale_act")
        act(*path, "deform_act")

    def dw(port, bn, path):
        if layout.deform:
            deform_block(port, bn, path)
        else:
            conv_bn(port, bn, path)

    conv_bn("layer0.0", "layer0.1", ("layer0",))
    act("layer0_act")
    for stage, nodes in enumerate(layout.stages, 1):
        layer = "layer{}".format(stage)
        for k in range(nodes):
            base, path = "{}.{}".format(layer, k), (layer, "node{}".format(k))
            if k == 0:
                dw(base + ".b1.0", base + ".b1.1", path + ("b1_conv1",))
                conv_bn(base + ".b1.2", base + ".b1.3", path + ("b1_conv2",))
                act(*path, "b1_act1")
            conv_bn(base + ".b2.0", base + ".b2.1", path + ("b2_conv1",))
            dw(base + ".b2.3", base + ".b2.4", path + ("b2_conv2",))
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
        deform_block(base, bn, (name,), mixer)
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
    if "layer0" not in variables["params"]:
        return _from_jax_by_name(variables)
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
    if "layer0.0.weight" not in sd:
        return _to_jax_by_name(sd)
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


# -- res, resdcn, dlav0, dla and hourglass: mapped by module name ----------

_BN_LEAVES = {"weight": ("params", "scale"), "bias": ("params", "bias"),
              "running_mean": ("batch_stats", "mean"),
              "running_var": ("batch_stats", "var")}


def _resnet_target(parts, dcn):
    """conv1, bn1, layer{s}.{b}..., deconv_layers.{i}..., heads."""
    head = parts[0]
    if head in ("conv1", "bn1"):
        return (head,), "module"
    if head.startswith("layer"):
        path = ("{}_{}".format(head, parts[1]),)
        leaf = parts[2]
        if leaf == "downsample":
            return path + (("down_conv", "down_bn")[int(parts[3])],), \
                "module"
        if leaf.startswith("conv"):
            return path + ("Conv_{}".format(int(leaf[4:]) - 1),), "module"
        return path + (leaf,), "module"
    if head == "deconv_layers":
        i, r = divmod(int(parts[1]), 6 if dcn else 3)
        if not dcn and r == 0:
            return ("deconv{}_kernel".format(i),), "convT"
        if not dcn:
            return ("deconv{}_bn".format(i),), "module"
        if r == 0:
            path = ("deconv{}_dcn".format(i),)
            return (path + ("conv_offset_mask",), "module") \
                if len(parts) > 2 else (path, "dcn")
        if r == 3:
            return ("deconv{}_up".format(i),), "convT"
        return ("deconv{}_bn{}".format(i, 1 if r == 1 else 2),), "module"
    return _pose_head_target(parts)


def _pose_head_target(parts):
    """{head}.0 / {head}.2 (or a one-conv {head}) -> head_{head}_*."""
    sub = "conv1" if parts[1:] == ["0"] else "out"
    return ("head_{}_{}".format(parts[0], sub),), "module"


def _dla_block(parts):
    """Inside a Tree: tree1 / tree2 nest; project.{0,1}; root.{conv,bn};
    a block's conv{1,2} / bn{1,2}."""
    out = []
    while parts:
        p = parts.pop(0)
        if p == "project":
            out.append(("project_conv", "project_bn")[int(parts.pop(0))])
        elif p == "root":
            out += ["root", "Conv_0" if parts.pop(0) == "conv" else "bn"]
        elif p in ("conv1", "conv2"):
            out.append("Conv_{}".format(int(p[4]) - 1))
        else:
            out.append(p)
    return tuple(out)


def _dla_target(parts, dcn):
    """base.*, dla_up.ida_{i}.*, ida_up.*, heads."""
    if parts[0] == "base":
        level = parts[1]
        if level in ("base_layer", "level0", "level1"):
            return (level, ("Conv_0", "bn")[int(parts[2])]), "module"
        return (level,) + _dla_block(parts[2:]), "module"
    if parts[0] in ("dla_up", "ida_up"):
        ida = parts[1:] if parts[0] == "dla_up" else parts
        path, (kind, j), rest = (ida[0],), ida[1].split("_"), ida[2:]
        if kind == "up":
            return path + ("up_{}_kernel".format(j),), "up"
        if dcn:
            sub = path + (ida[1],)
            if rest[0] == "actf":
                return sub + ("bn",), "module"
            return (sub + ("conv", "conv_offset_mask"), "module") \
                if len(rest) > 1 else (sub + ("conv",), "dcn")
        if kind == "proj":
            return path + ("proj_{}_{}".format(
                j, ("conv", "bn")[int(rest[0])]),), "module"
        return path + (ida[1], ("Conv_0", "bn")[int(rest[0])]), "module"
    return _pose_head_target(parts)


def _hg_residual(parts):
    out = []
    while parts:
        p = parts.pop(0)
        if p == "skip":
            out.append(("skip_conv", "skip_bn")[int(parts.pop(0))])
        elif p in ("conv1", "conv2"):
            out.append("Conv_{}".format(int(p[4]) - 1))
        else:
            out.append(p)
    return tuple(out)


def _hg_kp(parts):
    """kp_module: up1 / low1 / low3 chains ({name}.{j} -> res{j}), low2 a
    chain or the next kp_module."""
    name = parts[0]
    if parts[1].isdigit():
        return (name, "res" + parts[1]) + _hg_residual(parts[2:])
    return (name,) + _hg_kp(parts[1:])


def _hourglass_target(parts):
    head, s = parts[0], parts[1]
    conv_or_bn = "Conv_0" if parts[-1] == "conv" else "bn"
    if head == "pre" and s == "0":
        return ("pre_conv", conv_or_bn), "module"
    if head == "pre":
        return ("pre_res",) + _hg_residual(parts[2:]), "module"
    if head == "kps":
        return ("kp" + s,) + _hg_kp(parts[2:]), "module"
    if head == "cnvs":
        return ("cnv" + s, conv_or_bn), "module"
    if head in ("inters_", "cnvs_"):  # inters_conv0, cnvs_bn0, ...
        return ("{}_{}{}".format(head[:-1], ("conv", "bn")[int(parts[2])],
                                 s),), "module"
    if head == "inters":
        return ("inter_res" + s,) + _hg_residual(parts[2:]), "module"
    if parts[2] == "0":  # a head's 3x3 conv, then its 1x1
        return ("{}{}_conv".format(head, s), "Conv_0"), "module"
    return ("{}{}_out".format(head, s),), "module"


def family_of_state_dict(keys):
    """'res', 'resdcn', 'dlav0', 'dla' or 'hourglass' from the stem and
    up-path keys of a port ``state_dict``."""
    keys = set(keys)
    if "pre.0.conv.weight" in keys:
        return "hourglass"
    if "base.base_layer.0.weight" in keys:
        return "dla" if any(k.startswith("ida_up.") for k in keys) \
            else "dlav0"
    if "conv1.weight" in keys:
        return "resdcn" if "deconv_layers.0.conv_offset_mask.weight" \
            in keys else "res"
    raise ValueError("not a port state_dict of a known arch")


def flax_target(family, module):
    """(flax path, kind) of a port module name of `family`; kind is
    'module' (a conv's kernel / bias or a BN), 'dcn' (a DCN's weight /
    bias), 'convT' (a transposed conv's kernel, stored as the leaf the
    path ends in) or 'up' (a shared DLA up kernel, likewise)."""
    parts = module.split(".")
    if family in ("res", "resdcn"):
        return _resnet_target(parts, family == "resdcn")
    if family in ("dlav0", "dla"):
        return _dla_target(parts, family == "dla")
    return _hourglass_target(parts)


def _by_name_rows(family, keys):
    """(key, collection, path, leaf, kind) for every parameter and running
    statistic among `keys`."""
    keys = [k for k in keys if not k.endswith("num_batches_tracked")]
    bns = {k[:-len(".running_mean")] for k in keys
           if k.endswith(".running_mean")}
    rows = []
    for key in keys:
        module, leaf = key.rsplit(".", 1)
        path, kind = flax_target(family, module)
        if module in bns:
            coll, name = _BN_LEAVES[leaf]
            rows.append((key, coll, path, name, "bn"))
        elif kind in ("convT", "up"):
            rows.append((key, "params", path[:-1], path[-1], kind))
        else:
            name = "kernel" if kind == "module" and leaf == "weight" \
                else leaf
            rows.append((key, "params", path, name,
                         "conv" if leaf == "weight" else "vector"))
    return rows


# port layout <-> flax leaf, per kind
_TO_FLAX = {"conv": lambda w: np.ascontiguousarray(
                np.transpose(w, (2, 3, 1, 0))),
            "convT": lambda w: np.ascontiguousarray(
                np.transpose(w, (2, 3, 0, 1))),
            "up": lambda w: np.ascontiguousarray(w[0, 0]),
            "bn": lambda w: w, "vector": lambda w: w}
_FROM_FLAX = {"conv": lambda w: np.transpose(w, (3, 2, 0, 1)),
              "convT": lambda w: np.transpose(w, (2, 3, 0, 1)),
              "up": lambda w: w[None, None],
              "bn": lambda w: w, "vector": lambda w: w}


def _to_jax_by_name(sd):
    out = {"params": {}, "batch_stats": {}}
    for key, coll, path, leaf, kind in _by_name_rows(
            family_of_state_dict(sd), sd):
        tree = out[coll]
        for k in path:
            tree = tree.setdefault(k, {})
        tree[leaf] = _TO_FLAX[kind](sd[key])
    return out


def _arch_of_jax(params):
    """(create_model arch, heads, head_conv) of a JAX variables tree of
    one of the five by-name families."""
    if "pre_conv" in params:
        heads = {k[:-len("0_out")]: v["bias"].shape[0]
                 for k, v in params.items() if k.endswith("0_out")}
        return "hourglass", heads, 64
    heads = {k[5:-4]: v["bias"].shape[0] for k, v in params.items()
             if k.startswith("head_") and k.endswith("_out")}
    conv1 = [v for k, v in params.items()
             if k.startswith("head_") and k.endswith("_conv1")]
    head_conv = conv1[0]["kernel"].shape[-1] if conv1 else 0
    if "base_layer" in params:
        return ("dla_34" if "ida_up" in params else "dlav0_34"), heads, \
            head_conv
    from ..models.resnet import RESNET_SPEC
    blocks = [sum(k.startswith("layer{}_".format(s)) for k in params)
              for s in (1, 2, 3, 4)]
    expansion = 4 if "Conv_2" in params["layer1_0"] else 1
    depth = next(d for d, (block, layers) in RESNET_SPEC.items()
                 if layers == blocks and block.expansion == expansion)
    arch = "resdcn" if "deconv0_dcn" in params else "res"
    return "{}_{}".format(arch, depth), heads, head_conv


def _from_jax_by_name(variables):
    from ..models.factory import MODEL_FACTORY
    arch, heads, head_conv = _arch_of_jax(variables["params"])
    name, _, depth = arch.partition("_")
    with torch.device("meta"):
        model = MODEL_FACTORY[name](int(depth or 0), heads, head_conv)
    keys = list(model.state_dict())
    sd = {}
    for key, coll, path, leaf, kind in _by_name_rows(
            family_of_state_dict(keys), keys):
        tree = variables[coll]
        for k in path:
            tree = tree[k]
        sd[key] = torch.from_numpy(np.array(
            _FROM_FLAX[kind](np.asarray(tree[leaf], np.float32))))
    return sd
