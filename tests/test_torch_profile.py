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
  the JAX package;
- `span`: with no profiler recording it enters no record_function and
  leaves the detector's and the engine's outputs as they are; under a
  CPU profiler `process_batch_raw` and the graphed engine emit their
  spans once a call or a batch, nested in order; `trace` writes steps
  TRACE_SKIP + 1 to TRACE_SKIP + TRACE_STEPS of a longer run, all of a
  shorter one.
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


# -- spans and the trace window ------------------------------------------------

def _tiny_detector():
    from codenet_torch import config as cfg
    from codenet_torch.engine.detector import CtdetDetector
    from test_torch_common import calibrate_bn
    opt = cfg.update_dataset_info_and_set_heads(
        cfg.parse(["ctdet", "--dataset", "pascal", "--arch", "shufflenetv2",
                   "--input_res", "64", "--flip_test"]),
        cfg.DATASET_SPECS["pascal"])
    opt._device_warp_hw = (96, 96)
    model = create_model("shufflenetv2", HEADS, 64, device="cpu")
    calibrate_bn(model, rng(193).randn(4, 64, 64, 3).astype(np.float32))
    det = CtdetDetector(opt, state_dict=model.state_dict(), device="cpu")
    r = rng(194)
    frames = [r.randint(0, 256, hw + (3,)).astype(np.uint8)
              for hw in ((90, 72), (64, 96))]
    request = [np.stack(c) for c in zip(*(det.pre_process_raw(f)
                                          for f in frames))]
    return det, request


def _tiny_trainer():
    from codenet_torch import config as cfg
    from codenet_torch.engine import trainer as T
    opt = cfg.update_dataset_info_and_set_heads(
        cfg.parse(["ctdet", "--dataset", "pascal", "--arch", "shufflenetv2",
                   "--input_res", "64", "--batch_size", "2", "--gpus",
                   "-1"]), cfg.DATASET_SPECS["pascal"])
    trainer = T.Trainer(opt, device="cpu")
    trainer.init()
    return trainer


def _batches(n):
    from test_torch_common import qat_batch
    out = []
    for i in range(n):
        b = qat_batch()
        b["input_u8"] = np.roll(b["input_u8"], 5 * i, axis=2)
        out.append(b)
    return out


def _epoch(n):
    """A CPU trainer's graphed-engine epoch of n batches: its loss meter
    and weights."""
    torch.manual_seed(0)
    trainer = _tiny_trainer()
    stats = trainer.run_epoch("train", 1, _batches(n))
    return stats, {k: v.clone() for k, v in
                   trainer.model.state_dict().items()}


def _annotations(prof):
    """The codenet.* host annotations of a profiler: [(name, start, end)]
    by start."""
    return sorted(((e.name()[len("codenet."):], e.start_ns(),
                    e.start_ns() + e.duration_ns())
                   for e in prof.profiler.kineto_results.events()
                   if e.is_user_annotation()
                   and e.name().startswith("codenet.")),
                  key=lambda a: a[1])


def _cpu_profile():
    return torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CPU])


def test_span_without_a_profiler_enters_nothing(monkeypatch):
    """With no profiler recording, no span enters record_function, and
    the tiny detector's detections and an engine epoch's meters and
    weights equal those of the same calls under a recording profiler."""
    assert P.span("a") is P.span("b")
    det, request = _tiny_detector()

    def refuse(name):
        raise AssertionError("record_function entered: " + name)
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    dets = det.process_batch_raw(*request)
    stats, weights = _epoch(2)
    monkeypatch.undo()
    with _cpu_profile() as prof:
        traced_dets = det.process_batch_raw(*request)
        traced_stats, traced_weights = _epoch(2)
    assert _annotations(prof)
    torch.testing.assert_close(traced_dets, dets, rtol=0, atol=0)
    assert traced_stats == stats
    for k, v in weights.items():
        torch.testing.assert_close(traced_weights[k], v, rtol=0, atol=0,
                                   msg=k)


def test_detector_dispatch_spans_nest_in_order():
    """process_batch_raw under a CPU profiler: one detector.dispatch a
    call, holding upload, warp, net and decode once each, in that
    order."""
    det, request = _tiny_detector()
    with _cpu_profile() as prof:
        for _ in range(2):
            det.process_batch_raw(*request)
    spans = _annotations(prof)
    calls = [s for s in spans if s[0] == "detector.dispatch"]
    assert len(calls) == 2 and len(spans) == 10
    for _, lo, hi in calls:
        inner = [n for n, a, b in spans
                 if lo <= a and b <= hi and n != "detector.dispatch"]
        assert inner == ["detector.upload", "detector.warp",
                         "detector.net", "detector.decode"]


def test_engine_spans_once_a_batch():
    """Trainer.run_epoch's graphed engine on the CPU under a profiler:
    trainer.step, .stage and .eager once a batch, the stage and the step
    body inside the step, trainer.wait before each batch and at the
    loader's end, one trainer.flush after the last step."""
    n = 3
    trainer = _tiny_trainer()
    with _cpu_profile() as prof:
        trainer.run_epoch("train", 1, _batches(n))
    spans = _annotations(prof)
    names = [s[0] for s in spans]
    steps = [s for s in spans if s[0] == "trainer.step"]
    assert len(steps) == n
    assert names.count("trainer.wait") == n + 1
    assert names.count("trainer.flush") == 1
    assert not {"trainer.replay", "trainer.capture"} & set(names)
    for _, lo, hi in steps:
        inner = [s for s, a, b in spans
                 if lo <= a and b <= hi and s != "trainer.step"]
        assert inner == ["trainer.stage", "trainer.eager"]
    flush, = [s for s in spans if s[0] == "trainer.flush"]
    assert flush[1] >= steps[-1][2]


@pytest.mark.parametrize("n,marks", [(2, [0, 1, 2]), (6, [3, 4])],
                         ids=["short_run_whole", "steady_window"])
def test_trace_window_skips_the_first_steps(tmp_path, monkeypatch, n,
                                            marks):
    """`trace` over an engine epoch of n batches, TRACE_SKIP 2 and
    TRACE_STEPS 2 here (each batch starts a profiler step; step 0 is what
    runs before the first): a run of at most TRACE_SKIP steps writes
    them all; a longer one writes profiler steps TRACE_SKIP + 1 to
    TRACE_SKIP + TRACE_STEPS alone, with the engine's spans of those
    batches."""
    monkeypatch.setattr(P, "TRACE_SKIP", 2)
    monkeypatch.setattr(P, "TRACE_STEPS", 2)
    trainer = _tiny_trainer()
    with P.trace(str(tmp_path), device="cpu"):
        trainer.run_epoch("train", 1, _batches(n))
    (name,) = os.listdir(tmp_path)
    events = _events(tmp_path / name)
    assert sorted(int(e["name"].split("#")[1]) for e in events
                  if e.get("name", "").startswith("ProfilerStep#")) == marks
    names = [e.get("name") for e in events]
    assert names.count("codenet.trainer.step") == min(n, 2)
    assert names.count("codenet.trainer.stage") == min(n, 2)
    assert names.count("codenet.trainer.eager") == min(n, 2)
    assert not P._OPEN
