"""tools_torch/int8_audit.py against tools_tpu/int8_audit.py.

Both tools audit the same weights (a JAX .ckpt, which the port's loader
reads) on the same input (their RandomState(0) draw), config a at 32^2:
every activation quantizer's row, matched through
engine/jax_weights.py's module_table (the JAX intermediates path of a
quantizer and its port module name), holds the same clamped-vs-qat and
int8-vs-clamped divergences. The JAX tool runs as it is, eagerly on its
XLA deform path (~80 s; in Pallas interpret mode, or jitted, it takes
longer), which samples the int8 deform conv in f32; the port's samples
in f32 here too (layers.INT8_SAMPLE_DTYPE).
"""

import importlib.util
import os

import flax.linen as nn
import jax
import numpy as np
import torch

from test_torch_common import HEADS, perturb_variables, rng

from codenet_tpu.engine import checkpoint as JC
from codenet_tpu.engine.torch_import import convert_shufflenetv2
from codenet_torch.engine.jax_weights import (Layout, from_jax_variables,
                                              module_table,
                                              to_jax_variables)
from codenet_torch.models import create_model
from codenet_torch.models.layers import QuantSpec

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RES = 32
# a quantizer's two divergences (relative to its clamped output's max),
# port vs JAX: the same f32 values quantize alike but for rounding ties
# (XLA fuses scale * x - zp), each a level of 255
TOL = 1e-2


def _load(relpath, name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(REPO, relpath))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_audit_rows_match_jax(tmp_path, monkeypatch):
    w2 = maxpool = False
    base = create_model("shufflenetv2", HEADS, 64, w2=w2, maxpool=maxpool,
                        device="cpu")
    sd = {k: v.numpy() for k, v in base.state_dict().items()}
    variables = perturb_variables(convert_shufflenetv2(sd), seed=95,
                                  res=RES, w2=w2, maxpool=maxpool)
    fake = create_model("shufflenetv2", HEADS, 64, w2=w2, maxpool=maxpool,
                        qspec=QuantSpec(), device="cpu")
    fake.load_state_dict(from_jax_variables(variables), strict=False)
    with torch.no_grad():
        for _ in range(2):
            fake(torch.from_numpy(rng(96).rand(1, RES, RES, 3).astype(
                np.float32) * 1.5), update_stats=True)
    variables["quant_stats"] = to_jax_variables(
        fake.state_dict())["quant_stats"]
    ckpt = str(tmp_path / "audit.ckpt")
    JC.save_model(ckpt, 1, variables)

    jax_tool = _load("tools_tpu/int8_audit.py", "jax_int8_audit")
    # the JAX tool's init only gives its checkpoint loader a template to
    # read shapes and dtypes from: traced for those alone, it costs
    # nothing (eagerly, ~60 s)
    init = nn.Module.init
    monkeypatch.setattr(nn.Module, "init", lambda self, key, *a, **kw:
                        jax.eval_shape(lambda k, *b: init(self, k, *b, **kw),
                                       key, *a))
    port_tool = _load("tools_torch/int8_audit.py", "port_int8_audit")
    # the JAX model off Pallas (its XLA deform path) samples the int8
    # deform conv in f32: the port's does too here
    from codenet_torch.models import layers as TL
    monkeypatch.setattr(TL, "INT8_SAMPLE_DTYPE", torch.float32)
    ref = {r["layer"]: r for r in jax_tool.run_audit(ckpt, RES)}
    out = {r["layer"]: r for r in port_tool.run_audit(
        ckpt, RES, w2=w2, maxpool=maxpool)}

    layout = Layout((3, 7, 3), (True,) * 3, tuple(sorted(HEADS)))
    acts = [row for row in module_table(layout) if row.kind == "act"]
    matched = 0
    for row in acts:
        key = "/".join(row.path) + "/__call__"
        calls = sorted(k for k in ref if k == key or
                       k.startswith(key + "/"))
        assert calls, key
        for k in calls:
            port_key = row.port + k[len(key):]
            a, b = ref[k], out[port_key]
            assert a["shape"] == b["shape"], k
            for col in ("clamped_vs_qat", "int8_vs_clamped"):
                assert abs(a[col] - b[col]) <= TOL, (k, col, a[col], b[col])
            matched += 1
    # every quantizer, a stage's shared one once per call
    assert matched >= len(acts) + 8
    assert max(r["int8_vs_clamped"] for r in out.values()) < 0.05


def test_audit_w2_maxpool_rows():
    """--w2 --maxpool (config e) at 32^2, which the JAX tool does not
    build: the port tool on its own seeded weights and ranges gives a row
    for every activation quantizer of the table, deconv0's at 2153
    channels, and every int8-vs-clamped divergence under the tool's
    --lowering_tol default (0.05)."""
    port_tool = _load("tools_torch/int8_audit.py", "port_int8_audit")
    rows = port_tool.run_audit(None, RES, w2=True, maxpool=True)
    names = [r["layer"] for r in rows]
    layout = Layout((3, 7, 3), (True,) * 3, tuple(sorted(HEADS)))
    for row in module_table(layout):
        if row.kind == "act":
            assert any(n == row.port or n.startswith(row.port + "/")
                       for n in names), row.port
    assert any(r["shape"][-1] == 2153 and r["layer"].startswith(
        "deconv_layers.") for r in rows)
    worst = max(rows, key=lambda r: r["int8_vs_clamped"])
    assert worst["int8_vs_clamped"] < 0.05, worst
