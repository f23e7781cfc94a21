"""The port's roofline (tools_torch/roofline.py) against the model it
describes and the JAX package's tools_tpu/roofline.py:

- its useful FLOPs / 2 equal `utils/profile.py::profile_model`'s MACs
  exactly at configs a, c and d (PERF.md: 279,844,352 / 1,119,377,408 /
  3,507,274,240), per head and fused, and the JAX tool's at the same
  shapes; its parameter count equals the model's (the Adam row's);
- every forward row is, in order, an aten op the port's CPU forward
  dispatches at batch 1 (per head, fused, bf16, a train step's forward,
  --w2): kind, output size, and for a conv its input, weight, stride
  and groups; and each row names a module of PoseShuffleNetV2 of that
  shape (the fused heads: the parts they concatenate);
- the BN, ReLU, cast and upsample rows equal the dispatched ops kind by
  kind, and a train step's backward rows the backward's;
- the deform rows' bounds at H100 SXM peaks are PERF.md's kernel-table
  bounds, and chip_smoke.py takes the peaks and deform counts from the
  tool;
- the CLI runs with each flag; importing the tool loads no torch;
- the dataset fetch scripts parse, and each tools_torch command in them
  accepts the flags it is given.
"""

import argparse
import collections
import dataclasses
import os
import re
import shlex
import subprocess
import sys

import pytest
import torch
from torch.utils._python_dispatch import (TorchDispatchMode,
                                          _disable_current_modes)

from codenet_torch.models import create_model, layers
from codenet_torch.models.fused_heads import (apply_fused_heads,
                                              apply_fused_heads_train)
from codenet_torch.ops import deform_cuda as DC
from codenet_torch.utils.profile import count_params, profile_model
from tools_tpu import roofline as jax_roofline

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "tools_torch"))
import roofline as R  # noqa: E402

HEADS = {"hm": 20, "wh": 2, "reg": 2}
CONFIGS = {"a": (256, False, 279844352), "c": (512, False, 1119377408),
           "d": (512, True, 3507274240)}
# aten op -> the tool's forward row kind
FWD_KIND = {"aten.convolution.default": "conv",
            "aten.native_batch_norm.default": "bn",
            "aten.relu.default": "relu", "aten.hardtanh.default": "hardtanh",
            "aten._to_copy.default": "cast",
            "aten.upsample_nearest2d.default": "upsample",
            "aten.cat.default": "cat", "aten.clone.default": "shuffle",
            "aten.constant_pad_nd.default": "pad",
            "aten.add.Tensor": "bias_add"}


@pytest.mark.parametrize("config", sorted(CONFIGS))
def test_useful_macs_equal_profile_model_and_jax_tool(config):
    res, w2, macs = CONFIGS[config]
    model = create_model("shufflenetv2", HEADS, 64, w2=w2, device="cpu")
    got, params = profile_model(model, (1, res, res, 3))
    assert got == macs
    for fused in (False, True):
        m = R.build(res, w2, 1, "f32", fused_heads=fused)
        assert m.useful_flops / 2 == macs
        assert m.params == params == count_params(model)
    jax_m = jax_roofline.build(res=res, w2=w2, batch=1, dtype="f32")
    assert jax_m.useful_flops / 2 == macs


class _Log(TorchDispatchMode):
    """The aten ops a forward or backward dispatches: (op, args, out);
    the deform op is one entry, its plain version's ops unseen."""

    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        self.ops.append((str(func), args, out))
        return out


@pytest.fixture
def deform_as_one_op(monkeypatch):
    """Each deform call (forward and backward) logged by the active _Log
    as one entry, its plain version run outside the log."""
    fwd, bwd = layers.codesign_deform_conv_fast, DC.codesign_deform_conv_bwd
    logs = []

    def one(name, fn):
        def call(x, *rest):
            if logs:
                logs[-1].ops.append((name, (x,) + rest, None))
            with _disable_current_modes():
                return fn(x, *rest)
        return call
    monkeypatch.setattr(layers, "codesign_deform_conv_fast",
                        one("deform", fwd))
    monkeypatch.setattr(DC, "codesign_deform_conv_bwd",
                        one("deform_bwd", bwd))
    return logs


def _forward(model, fused, train):
    x = torch.randn(1, 64, 64, 3, generator=torch.Generator().manual_seed(0))
    model.train(train)
    if fused:
        heads = apply_fused_heads_train if train else apply_fused_heads
        return heads(model, model(x, return_neck=True))
    return model(x)


def _module(model, name):
    """The module a row names; the fused heads' parts, joined by +."""
    prefix, _, idx = name.rpartition(".")
    if "+" in prefix:
        return [model.get_submodule("%s.%s" % (p, idx))
                for p in prefix.split("+")]
    return [model.get_submodule(name)]


def _check_module(model, row):
    mods = _module(model, row.name)
    if row.kind == "conv":
        assert all(isinstance(m, torch.nn.Conv2d) for m in mods)
        assert all((m.kernel_size, m.stride) == ((row.k,) * 2,
                                                 (row.stride,) * 2)
                   for m in mods)
        # fused: the stem reads the neck once (every part's input), the
        # depthwise and class convs a part each (a group each at least);
        # the class conv's outputs padded to the largest head's
        if row.groups == 1:
            assert all(m.in_channels == row.cin for m in mods)
        else:
            assert sum(m.in_channels for m in mods) == row.cin
            assert sum(m.groups for m in mods) == row.groups
        assert sum(m.out_channels for m in mods) <= row.cout
        assert len(mods) > 1 or mods[0].out_channels == row.cout
    elif row.kind in ("bn", "bn_train"):
        assert sum(m.num_features for m in mods) == row.cin
    elif row.kind == "relu":
        assert all(isinstance(m, torch.nn.ReLU) for m in mods)
    elif row.kind == "deform":
        assert mods[0].weight.shape == (row.cin, 1, 3, 3)
    elif row.kind == "hardtanh":
        assert isinstance(mods[0], layers.CodesignDeformBlock)
    elif row.kind == "upsample":
        assert isinstance(mods[0], torch.nn.Upsample)
    elif row.kind == "shuffle":
        assert mods[0].b2[5].out_channels * 2 == row.cin


MODES = {"per_head": dict(fused=False), "fused": dict(fused=True),
         "fused_bf16": dict(fused=True, dtype="bf16"),
         "per_head_bf16": dict(fused=False, dtype="bf16"),
         "fused_train": dict(fused=True, train=True),
         "fused_w2": dict(fused=True, w2=True)}


def _mode(name):
    mode = dict(dict(dtype="f32", train=False, w2=False), **MODES[name])
    model = create_model("shufflenetv2", HEADS, 64, w2=mode["w2"],
                         dtype=torch.bfloat16 if mode["dtype"] == "bf16"
                         else None, device="cpu")
    rows = R.build(64, mode["w2"], 1, mode["dtype"],
                   fused_heads=mode["fused"], train=mode["train"])
    return mode, model, rows


def _out(out):
    return out[0] if isinstance(out, (tuple, list)) else out


@pytest.mark.parametrize("name", sorted(MODES))
def test_rows_are_the_dispatched_forward(name, deform_as_one_op):
    mode, model, m = _mode(name)
    log = _Log()
    deform_as_one_op.append(log)
    with log, torch.set_grad_enabled(mode["train"]):
        _forward(model, mode["fused"], mode["train"])
    ops = [(FWD_KIND.get(op, op), args, out) for op, args, out in log.ops
           if FWD_KIND.get(op, op) in FWD_KIND.values()
           or op == "deform"]
    assert [r.kind.replace("bn_train", "bn") for r in m.rows] \
        == [k for k, _, _ in ops]
    for row, (kind, args, out) in zip(m.rows, ops):
        _check_module(model, row)
        if kind == "conv":
            x, wt = args[0], args[1]
            assert tuple(x.shape) == (1, row.cin, row.h, row.w)
            assert tuple(wt.shape) == (row.cout, row.cin // row.groups,
                                       row.k, row.k)
            assert list(args[3]) == [row.stride] * 2
            assert args[8] == row.groups
            assert tuple(out.shape) == (1, row.cout, row.ho, row.wo)
        elif kind == "deform":
            assert tuple(args[0].shape) == (1, row.h, row.w, row.cin)
            assert str(args[0].dtype) == {"f32": "torch.float32",
                                          "bf16": "torch.bfloat16"}[row.dtype]
        elif kind == "upsample":
            assert tuple(out.shape) == (1, row.cin, 2 * row.h, 2 * row.w)
        elif kind == "cat":
            assert _out(out).numel() == row.h * row.w * row.cin * row.parts
        elif kind == "pad":
            assert out.numel() == row.cout and args[0].numel() == row.cin
        else:
            assert _out(out).numel() == row.h * row.w * row.cin
            if kind == "cast":
                assert str(out.dtype)[6:] == {"f32": "float32",
                                              "bf16": "bfloat16"}[row.dtype]


@pytest.mark.parametrize("name", ["fused", "per_head_bf16", "fused_train"])
def test_tail_counts_equal_the_dispatched_ops(name, deform_as_one_op):
    """The BN, ReLU, cast and upsample passes, kind by kind."""
    mode, model, m = _mode(name)
    log = _Log()
    deform_as_one_op.append(log)
    with log, torch.set_grad_enabled(mode["train"]):
        _forward(model, mode["fused"], mode["train"])
    got = collections.Counter(FWD_KIND.get(op) for op, _, _ in log.ops)
    want = collections.Counter(r.kind.replace("bn_train", "bn")
                               for r in m.rows)
    for kind in ("bn", "relu", "cast", "upsample"):
        assert got[kind] == want[kind], kind
    assert want["bn"] > 60 and want["upsample"] == 3
    assert (want["cast"] > 0) == (mode["dtype"] == "bf16")


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_train_rows_are_the_dispatched_backward(dtype, deform_as_one_op):
    """A train step's backward (fused heads): each conv's dgrad, wgrad and
    bias gradient (a depthwise 3x3 conv's dgrad and wgrad one `dw_bwd`
    row), every tail's backward, the deform backward, the
    channel splits' zero-filled gradients and copies, the gradient sums,
    the shuffles' copies and the casts, count for count."""
    model = create_model("shufflenetv2", HEADS, 64, device="cpu",
                         dtype=torch.bfloat16 if dtype == "bf16" else None)
    out = _forward(model, True, True)
    loss = sum((v.float() ** 2).sum() for v in out.values())
    log = _Log()
    deform_as_one_op.append(log)
    with log:
        loss.backward()
    got = collections.Counter()
    for op, args, _ in log.ops:
        if op == "aten.convolution_backward.default":
            # a depthwise 3x3 conv's dx and dW: one kernel on a card
            # (ops/dwconv_cuda.py; the CPU's backward runs the library's)
            if tuple(args[2].shape[1:]) == (1, 3, 3) \
                    and args[9] == args[2].shape[0]:
                assert list(args[-1][:2]) == [True, True]
                got["dw_bwd"] += 1
                continue
            got.update(k for k, on in zip(("dgrad", "wgrad", "bgrad"),
                                          args[-1]) if on)
        else:
            got[op] += 1
    m = R.build(64, False, 1, dtype, fused_heads=True, train=True)
    want = collections.Counter(r.kind for r in R.train_rows(m))
    bias_grads = got["bgrad"] + got["aten.sum.dim_IntList"]
    assert (got["dgrad"], got["wgrad"], bias_grads, got["dw_bwd"]) \
        == (want["dgrad"], want["wgrad"], want["bgrad"], want["dw_bwd"])
    assert want["dw_bwd"] == 20
    assert got["aten.native_batch_norm_backward.default"] == want["bn_bwd"]
    assert got["aten.threshold_backward.default"] == want["relu_bwd"]
    assert got["aten.hardtanh_backward.default"] == want["hardtanh_bwd"]
    assert got["aten.upsample_nearest2d_backward.default"] \
        == want["upsample_bwd"]
    assert got["deform_bwd"] == want["deform_bwd"] == 3
    assert got["aten.slice_backward.default"] == want["zeros"] \
        == want["copy"]
    assert got["aten.add.Tensor"] == want["grad_add"]
    assert got["aten.clone.default"] == want["shuffle"]
    assert got["aten._to_copy.default"] == want["cast"]
    assert want["adam"] == 1


@pytest.mark.parametrize("res,batch,train,want_ms,places,roof", [
    (256, 2, False, 0.00127, 5, "hbm"), (512, 2, False, 0.00504, 5, "hbm"),
    (256, 32, True, 0.0314, 4, "cuda"), (512, 32, True, 0.1257, 4, "cuda")],
    ids=["fwd_256", "fwd_512", "bwd_256", "bwd_512"])
def test_deform_bounds_are_the_kernel_table(res, batch, train, want_ms,
                                            places, roof):
    """PERF.md's kernel table: the served forward's three calls (bytes)
    and a train step's three backward calls (operations)."""
    m = R.build(res, False, batch, "f32", train=train)
    rows = R.train_rows(m) if train else m.rows
    kind = "deform_bwd" if train else "deform"
    peaks = R.card_peaks("NVIDIA H100 80GB HBM3")
    bounds = [r.bound(peaks) for r in rows if r.kind == kind]
    assert len(bounds) == 3 and {b[1] for b in bounds} == {roof}
    assert round(sum(b[0] for b in bounds) * 1e3, places) == want_ms


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_row_op_keys_the_cost(dtype):
    """Row.op, the key chip_smoke.py times a row's op under, is every
    field but the module's name and the costs, and rows with one op have
    one cost."""
    costs = ("tc_flops", "cc_ops", "bytes")
    fields = [f.name for f in dataclasses.fields(R.Row)]
    assert list(R.Row.OP_FIELDS) == [f for f in fields
                                     if f not in ("name", "useful") + costs]
    m = R.build(256, False, 8, dtype, fused_heads=True, train=True)
    seen = {}
    for row in list(m.rows) + R.train_rows(m):
        cost = tuple(getattr(row, c) for c in costs)
        assert seen.setdefault(row.op(), cost) == cost, row


def test_largest_numel_holds_every_map_and_weight():
    """The roofline phase sizes its input buffer by Row.largest_numel."""
    m = R.build(256, False, 128, "f32", fused_heads=True)
    biggest = max(m.rows, key=R.Row.largest_numel)
    assert (biggest.name, biggest.kind) == ("hm+reg+wh.0", "conv")
    assert biggest.largest_numel() == 128 * 64 * 64 * 192
    up = next(r for r in m.rows if r.kind == "upsample")
    assert up.largest_numel() == 4 * up.n * up.h * up.w * up.cin
    stem = next(r for r in m.rows if r.name == "layer0.0")
    # its input: the stride-4 output is half of it
    assert stem.largest_numel() == 128 * 256 * 256 * 3
    adam = next(r for r in R.train_rows(R.build(256, False, 8, "f32",
                                                 train=True))
                if r.kind == "adam")
    assert adam.largest_numel() == adam.cin


def test_chip_smoke_takes_peaks_and_deform_counts_from_the_tool():
    with open(os.path.join(REPO, "chip_smoke.py")) as f:
        text = f.read()
    assert re.search(r"^from roofline import \(", text, re.M)
    for copy in ("CARD_PEAKS =", "FLOPS_PER_OUT =", "BWD_FLOPS_PER_ELEM =",
                 "3.35e12", "def card_peaks"):
        assert copy not in text, copy
    assert R.card_peaks("NVIDIA H100 80GB HBM3").hbm == 3.35e12
    assert R.card_peaks("NVIDIA H100 PCIe").hbm == 2.0e12
    assert R.card_peaks("NVIDIA H200").tf32 == 495e12


@pytest.mark.parametrize("argv", [
    [], ["--dtype", "f32"], ["--train", "--batch", "32"],
    ["--w2", "--res", "512", "--batch", "32", "--dtype", "f32"],
    ["--fused_heads"], ["--train", "--fused_heads", "--dtype", "f32"]],
    ids=["bf16", "f32", "train", "w2", "fused_heads", "train_fused"])
def test_cli_prints_total(argv, capsys):
    R.main(argv)
    text = capsys.readouterr().out
    assert "TOTAL" in text and "NVIDIA H100 SXM" in text
    assert "SoL img/s" in text
    if "--train" in argv:
        assert "optimizer" in text and "deform_bwd" in text


def test_importing_the_tool_loads_no_torch():
    proc = subprocess.run(
        [sys.executable, "-c",
         "import sys; sys.path.insert(0, 'tools_torch'); import roofline; "
         "bad = [k for k in sys.modules if k.split('.')[0] in "
         "('torch', 'jax', 'codenet_tpu', 'codenet_torch')]; "
         "assert not bad, bad"], cwd=REPO, capture_output=True, text=True,
        timeout=60)
    assert proc.returncode == 0, proc.stderr


class _Parsed(Exception):
    pass


def _commands(script):
    """Each `python tools_torch/<tool>.py ...` command of a shell script,
    continuation lines joined: (tool, argv)."""
    with open(os.path.join(REPO, "tools_torch", script)) as f:
        text = f.read().replace("\\\n", " ")
    out = []
    for line in text.splitlines():
        words = shlex.split(line, comments=True)
        if words[:1] == ["python"] and words[1].startswith("tools_torch/"):
            out.append((words[1], words[2:]))
    return out


@pytest.mark.parametrize("script,tool,calls", [
    ("get_pascal_voc.sh", "merge_pascal_json", 1),
    ("get_kitti.sh", "convert_kitti_to_coco", 2)])
def test_fetch_scripts_parse_and_pass_accepted_flags(script, tool, calls,
                                                     monkeypatch):
    proc = subprocess.run(["bash", "-n",
                           os.path.join(REPO, "tools_torch", script)],
                          capture_output=True, text=True, timeout=60)
    assert proc.returncode == 0, proc.stderr
    commands = _commands(script)
    assert [c[0] for c in commands] == ["tools_torch/%s.py" % tool] * calls
    module = __import__(tool)
    parse = argparse.ArgumentParser.parse_args

    def parse_only(self, args=None, namespace=None):
        raise _Parsed(parse(self, args, namespace))
    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", parse_only)
    for _, argv in commands:
        with pytest.raises(_Parsed) as got:
            module.main(argv)
        assert got.value.args[0].out.endswith(".json")
