"""The port's model accounting and profiler traces (utils/profile.py)
against the JAX package's utils/profile.py:

- `count_params` equals the JAX count of the same carried weights (the
  JAX package's own converter) on configs a and d (--w2);
- `count_flops` equals the JAX count (XLA's cost analysis) exactly on an
  unpadded 3x3 conv, and on a 1x1 conv feeding a matmul; on the whole
  config-a model the two differ (XLA counts only the taps of a padded
  conv inside the image, and one FLOP an elementwise op), and the test
  prints both and their ratio;
- the deform ops count by their formula: `deform_conv2d` as its plain
  contraction counts, `codesign_deform_conv_fast` as a depthwise conv
  of its shape (its backward twice that), and the model counts the same
  whether the op takes its plain version (the CPU) or the kernel route
  (a card), simulated here with the plain version behind the kernel
  route's wrappers;
- `profile_model` prints ``MACs: ... Parameters: ...``;
- `trace` writes a ``*.pt.trace.json`` (the rank in its worker name),
  and a trace of a card that records no CUDA event raises; `cli.main
  --trace` and `cli.test --trace` (per image, serial and --batch_eval)
  write theirs into <debug_dir>/trace, as tests/test_e2e.py checks for
  the JAX package.
"""

import json
import os

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax
import jax.numpy as jnp

from test_torch_common import HEADS, rng

from codenet_tpu.engine.torch_import import convert_shufflenetv2
from codenet_tpu.models import create_model as jax_create_model
from codenet_tpu.utils import profile as JP
from codenet_torch.models import create_model
from codenet_torch.ops import deform_cuda as DC
from codenet_torch.ops.deform_conv import deform_conv2d
from codenet_torch.utils import profile as P

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("w2", [False, True], ids=["config_a", "config_d"])
def test_count_params_matches_jax(w2):
    model = create_model("shufflenetv2", HEADS, 64, w2=w2, device="cpu")
    sd = {k: v.numpy() for k, v in model.state_dict().items()}
    variables = convert_shufflenetv2(sd, heads=tuple(sorted(HEADS)))
    assert P.count_params(model) == JP.count_params(variables)


def _conv_valid_nhwc(x, w):  # JAX, HWIO
    return jax.lax.conv_general_dilated(
        x, w, (1, 1), "VALID", dimension_numbers=("NHWC", "HWIO", "NHWC"))


def test_count_flops_matches_jax_on_valid_conv_and_matmul():
    r = rng(190)
    x = r.randn(2, 16, 16, 3).astype(np.float32)
    w = r.randn(3, 3, 3, 8).astype(np.float32)
    want = JP.count_flops(_conv_valid_nhwc, jnp.asarray(x), jnp.asarray(w))
    got = P.count_flops(lambda a, b: F.conv2d(a, b), torch.from_numpy(
        x).permute(0, 3, 1, 2), torch.from_numpy(w).permute(3, 2, 0, 1))
    assert got == want == 2 * 2 * 14 * 14 * 8 * 27

    w1 = r.randn(1, 1, 3, 8).astype(np.float32)
    m = r.randn(8, 5).astype(np.float32)

    def jfn(x, w1, m):
        return _conv_valid_nhwc(x, w1).reshape(-1, 8) @ m

    def tfn(x, w1, m):
        y = F.conv2d(x.permute(0, 3, 1, 2), w1.permute(3, 2, 0, 1))
        return y.permute(0, 2, 3, 1).reshape(-1, 8) @ m
    want = JP.count_flops(jfn, *map(jnp.asarray, (x, w1, m)))
    got = P.count_flops(tfn, *map(torch.from_numpy, (x, w1, m)))
    assert got == want == 2 * 512 * 3 * 8 + 2 * 512 * 8 * 5


def test_model_flops_against_jax():
    """Config a at 64²: the port's count and the JAX package's, printed
    with their ratio (not held equal: XLA counts padded convs' inside
    taps and elementwise ops; the port, every tap and matmuls and convs
    only)."""
    model = create_model("shufflenetv2", HEADS, 64, device="cpu")
    sd = {k: v.numpy() for k, v in model.state_dict().items()}
    variables = convert_shufflenetv2(sd, heads=tuple(sorted(HEADS)))
    jmodel = jax_create_model("shufflenetv2", HEADS, 64)
    x = np.zeros((1, 64, 64, 3), np.float32)
    want = JP.count_flops(
        lambda v, x: jmodel.apply(v, x, train=False), variables,
        jnp.asarray(x))
    with torch.no_grad():
        got = P.count_flops(model, torch.from_numpy(x))
    print("config a 64x64 FLOPs: port {} JAX {} ratio {:.4f}".format(
        got, int(want), want / got))
    assert 0.5 < want / got < 1.5


def test_deform_ops_count_their_formula():
    r = rng(191)
    x = torch.from_numpy(r.randn(2, 8, 8, 6).astype(np.float32))
    off = torch.from_numpy(r.randn(2, 8, 8, 18).astype(np.float32))
    w = torch.from_numpy(r.randn(3, 3, 6, 4).astype(np.float32))
    from torch.utils.flop_counter import FlopCounterMode
    with FlopCounterMode(display=False) as plain:  # no tally: plain ops
        deform_conv2d(x, off, w)
    assert P.count_flops(deform_conv2d, x, off, w) == \
        plain.get_total_flops() == 2 * 2 * 64 * 9 * 6 * 4
    mask = torch.rand(2, 8, 8, 9)
    assert P.count_flops(lambda: deform_conv2d(x, off, w, mask=mask)) == \
        2 * 2 * 64 * 9 * 6 * 4 + 2 * 64 * 9 * 6

    xs = x.clone().requires_grad_()
    s = torch.rand(2, 8, 8, 1) + 0.5
    wd = torch.randn(3, 3, 1, 6, requires_grad=True)
    with torch.no_grad():
        dense = P.count_flops(lambda: F.conv2d(
            xs.permute(0, 3, 1, 2), wd.permute(3, 2, 0, 1), padding=1,
            groups=6))
    fwd = P.count_flops(DC.codesign_deform_conv_fast, xs, s, wd)
    step = P.count_flops(
        lambda: DC.codesign_deform_conv_fast(xs, s, wd).sum().backward())
    # the backward: dx and dw, each as many as the forward (an ungrouped
    # conv's backward counts so; FlopCounterMode's grouped formula does
    # not divide dw by the groups)
    assert fwd == dense == 2 * 2 * 64 * 9 * 6 and step == 3 * fwd


def test_model_flops_equal_on_both_routes(monkeypatch):
    """The config-a forward and a train step count the same through the
    plain versions (the CPU route) and through the kernel route's
    wrappers (a card's), here with the plain versions behind them."""
    model = create_model("shufflenetv2", HEADS, 64, device="cpu")
    x = torch.from_numpy(rng(192).randn(2, 64, 64, 3).astype(np.float32))

    def counts():
        with torch.no_grad():
            fwd = P.count_flops(model, x)
        step = P.count_flops(lambda: model(x)["hm"].sum().backward())
        return fwd, step
    cpu = counts()
    launched = []
    monkeypatch.setattr(DC, "_route", lambda t: False)
    monkeypatch.setattr(DC, "_check", lambda *a: None)
    monkeypatch.setattr(DC, "_launch", lambda *a: launched.append(1) or
                        DC.codesign_deform_conv_plain(*a))
    monkeypatch.setattr(DC, "_launch_bwd", lambda *a: launched.append(2) or
                        DC.codesign_deform_conv_bwd_plain(*a))
    assert counts() == cpu
    assert launched.count(1) == 6 and launched.count(2) == 3


def test_profile_model_prints_macs_and_parameters(capsys):
    model = create_model("shufflenetv2", HEADS, 64, device="cpu")
    macs, n = P.profile_model(model, (1, 64, 64, 3))
    with torch.no_grad():
        flops = P.count_flops(model, torch.zeros(1, 64, 64, 3))
    assert macs == flops / 2 and n == P.count_params(model)
    assert capsys.readouterr().out.strip() == \
        "MACs: {} Parameters: {}".format(macs, n)


def _events(path):
    with open(path) as f:
        return json.load(f)["traceEvents"]


def test_trace_writes_a_file_and_raises_without_cuda_events(tmp_path,
                                                            monkeypatch):
    with P.trace(str(tmp_path / "a"), device="cpu", worker="rank1"):
        torch.randn(8, 8) @ torch.randn(8, 8)
    (name,) = os.listdir(tmp_path / "a")
    assert name.startswith("rank1.") and name.endswith(".pt.trace.json")
    assert any(e.get("name") == "aten::mm"
               for e in _events(tmp_path / "a" / name))
    # a trace of a card that holds no CUDA event (this build records none)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    with pytest.raises(RuntimeError, match="no CUDA activity"):
        with P.trace(str(tmp_path / "b"), device="cuda"):
            torch.randn(8, 8) @ torch.randn(8, 8)


def test_cli_trace_train_and_eval(tmp_path):
    """cli.main --trace: the epochs' trace and the final eval's; then
    cli.test --trace per image (prefetched and serial) and batched: one
    file each, every one naming the model's convolutions."""
    import shutil
    from synthetic import make_voc_dataset
    from codenet_torch.cli.main import main
    from codenet_torch.cli.test import main as test_main
    root = str(tmp_path)
    make_voc_dataset(root, num_images=3, img_w=160, img_h=120)
    common = ["ctdet", "--dataset", "pascal", "--arch", "shufflenetv2",
              "--input_res", "64", "--gpus", "-1", "--data_dir", root,
              "--num_workers", "1", "--trace"]
    trace_dir = os.path.join(REPO, "exp", "ctdet", "torch_profile",
                             "debug", "trace")
    shutil.rmtree(os.path.dirname(os.path.dirname(trace_dir)),
                  ignore_errors=True)
    main(common + ["--exp_id", "torch_profile", "--batch_size", "2",
                   "--num_epochs", "1", "--num_iters", "1",
                   "--val_intervals", "-1"])
    assert len(os.listdir(trace_dir)) == 2
    load = ["--load_model", os.path.join(os.path.dirname(os.path.dirname(
        trace_dir)), "model_last.pth"), "--exp_id", "torch_profile"]
    for extra in ([], ["--not_prefetch_test"], ["--batch_eval", "2"]):
        test_main(common + load + extra)
    names = os.listdir(trace_dir)
    assert len(names) == 5
    for name in names:
        assert name.endswith(".pt.trace.json")
        assert any(e.get("name") == "aten::convolution"
                   for e in _events(os.path.join(trace_dir, name)))
