"""The port's graphed epoch engine (engine/trainer.py::_run_epoch_scan)
against its per-step path and against the JAX package's scan engine.

Mirrors tests/test_scan_epoch.py's cases (FP32 with and without
--device_cache, stats read in chunks against one chunk, QAT, the ragged
tail) on a
synthetic VOC set at 64^2, batch 2, 3 steps from the conditioned start
(every BN bias but the heads' last raised: test_torch_train.py says
why). On the CPU the engine runs the step body per batch, so its final
state and its loss meters equal the per-step
path's bit for bit. Against the JAX scan engine (its steps on its XLA
deform path), on the same batch stream from the same weights: each loss
meter within 5e-3, every parameter and BN running statistic within 5e-3
(relative and absolute), and the parameter updates within 5e-2 relative
L2, 1e-1 in QAT (Adam's first steps move each parameter by about lr; the
few whose gradient is nearly 0 move either way in either framework, and
in QAT a fake quantizer's level that rounds the other way moves some
gradients by percents).
The card's graph replay is held in tests/test_torch_cuda.py and
chip_smoke.py's graphs phase.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from test_torch_common import HEADS, raise_bn_biases

pytest.importorskip("cv2")

from codenet_tpu import config as jcfg
from codenet_tpu.engine.trainer import Trainer as JaxTrainer
from codenet_torch import config as tcfg
from codenet_torch.data.datasets import get_dataset
from codenet_torch.data.loader import DataLoader
from codenet_torch.engine import trainer as T
from codenet_torch.engine.jax_weights import (from_jax_variables,
                                              to_jax_variables)
from codenet_torch.models.layers import QuantSpec

N_ITERS = 3
TOL = 5e-3
# measured: 1.8% (FP32, host and cache batches), 5.8% (QAT: a fake
# quantizer's level that rounds the other way moves a gradient by percents)
UPDATE_TOL = {False: 5e-2, True: 1e-1}


@pytest.fixture(scope="module")
def voc_root(tmp_path_factory):
    from synthetic import make_voc_dataset
    root = tmp_path_factory.mktemp("torch_scan_voc")
    make_voc_dataset(str(root), num_images=8, img_w=160, img_h=120)
    return str(root)


@pytest.fixture(scope="module")
def start():
    """The conditioned FP32 start, as a port state_dict."""
    opt = _opt(tcfg, "unused")
    model = T.Trainer(opt, device="cpu").model
    raise_bn_biases(model, HEADS)
    return {k: v.clone() for k, v in model.state_dict().items()}


def _opt(cfg, voc_root, extra=()):
    args = ["ctdet", "--dataset", "pascal", "--arch", "shufflenetv2",
            "--input_res", "64", "--batch_size", "2", "--gpus", "-1",
            "--data_dir", voc_root, *extra]
    return cfg.update_dataset_info_and_set_heads(
        cfg.parse(args), cfg.DATASET_SPECS["pascal"])


def _batches(voc_root, extra=(), batch=2, drop_last=True):
    """One epoch's numpy batches of the port's loader (the stream both
    engines and both packages take), and the cache stack of
    --device_cache."""
    opt = _opt(tcfg, voc_root, extra)
    ds = get_dataset("pascal", "ctdet")(opt, "train")
    stack = None
    if opt.device_cache:
        from codenet_torch.data.device_cache import ImageCache
        cache = ImageCache.build(ds)
        ds._image_cache_dims = cache.dims
        stack = cache.images.copy()
    loader = DataLoader(ds, batch, shuffle=True, num_workers=1, seed=7,
                        drop_last=drop_last)
    return list(loader), stack


def _env(monkeypatch, scan, stats_every=None):
    monkeypatch.setenv("CODENET_SCAN_EPOCH", "1" if scan else "0")
    if stats_every is not None:
        monkeypatch.setattr(T, "STATS_EVERY", stats_every)


def _port_epoch(monkeypatch, voc_root, state, batches, stack, scan,
                extra=(), qspec=None, stats_every=None, n_iters=N_ITERS):
    _env(monkeypatch, scan, stats_every)
    trainer = T.Trainer(_opt(tcfg, voc_root, extra), qspec=qspec,
                        device="cpu")
    trainer.model.load_state_dict(state, strict=qspec is None)
    trainer.init()
    if stack is not None:
        trainer.image_cache = torch.from_numpy(stack)
    calls = []
    real = trainer._run_epoch_scan
    trainer._run_epoch_scan = lambda *a: calls.append(1) or real(*a)
    stats = trainer.run_epoch("train", 1, [dict(b) for b in batches],
                              num_iters=n_iters)
    assert len(calls) == int(scan)
    return stats, trainer.model.state_dict()


def _jax_epoch(monkeypatch, voc_root, state, batches, stack, extra=(),
               qat=False):
    """The JAX scan engine over the same batches from the port's start."""
    _env(monkeypatch, True)
    opt = _opt(jcfg, voc_root, extra)
    qspec = None
    if qat:
        from codenet_tpu.models.layers import QuantSpec as JaxQuantSpec
        qspec = JaxQuantSpec(w_bit=4, a_bit=8, wt_mode="symmetric",
                             act_mode="asymmetric", per_channel=True)
    jtr = JaxTrainer(opt, qspec=qspec)
    variables = to_jax_variables(state)
    jtr.variables = jax.tree_util.tree_map(jnp.asarray, variables)
    jtr.opt_state = jtr.tx.init(jtr.variables["params"])
    if stack is not None:
        jtr.image_cache = jnp.asarray(stack)
    stats = jtr.run_epoch("train", 1, [dict(b) for b in batches],
                          num_iters=N_ITERS)
    return stats, from_jax_variables(jax.tree_util.tree_map(
        np.asarray, dict(jtr.variables)))


def _assert_equal(a, b):
    (stats_a, state_a), (stats_b, state_b) = a, b
    assert stats_a == stats_b
    assert set(state_a) == set(state_b)
    for k in state_a:
        assert torch.equal(state_a[k], state_b[k]), k


def _assert_close_to_jax(port, ref, start, qat=False):
    (stats, state), (jstats, jstate) = port, ref
    assert set(stats) == set(jstats)
    for k in jstats:
        np.testing.assert_allclose(stats[k], jstats[k], rtol=TOL,
                                   err_msg=k)
    num = den = 0.0
    for k, ref_v in jstate.items():
        got = state[k].numpy()
        np.testing.assert_allclose(got, ref_v.numpy(), rtol=TOL, atol=TOL,
                                   err_msg=k)
        if k.endswith(("weight", "bias")):
            du = got.astype(np.float64) - start[k].numpy()
            dj = ref_v.numpy().astype(np.float64) - start[k].numpy()
            num += float(((du - dj) ** 2).sum())
            den += float((dj ** 2).sum())
    rel = (num / den) ** 0.5
    assert den > 0 and rel <= UPDATE_TOL[qat], rel


@pytest.mark.parametrize("device_cache", [False, True],
                         ids=["host", "device_cache"])
def test_scan_epoch_matches_per_step(monkeypatch, voc_root, start,
                                     device_cache):
    extra = ("--device_cache",) if device_cache else ()
    batches, stack = _batches(voc_root, extra)
    assert len(batches) >= N_ITERS
    scan = _port_epoch(monkeypatch, voc_root, start, batches, stack, True,
                       extra)
    step = _port_epoch(monkeypatch, voc_root, start, batches, stack, False,
                       extra)
    _assert_equal(scan, step)
    ref = _jax_epoch(monkeypatch, voc_root, start, batches, stack, extra)
    _assert_close_to_jax(scan, ref, start)


def test_scan_epoch_chunked_matches_one_chunk(monkeypatch, voc_root, start):
    """Stats read from the device after every step (STATS_EVERY 1, a
    chunk of one step): the same state and meters as one read at the
    epoch's end."""
    batches, _ = _batches(voc_root)
    one = _port_epoch(monkeypatch, voc_root, start, batches, None, True,
                      n_iters=4)
    chunked = _port_epoch(monkeypatch, voc_root, start, batches, None, True,
                          stats_every=1, n_iters=4)
    _assert_equal(chunked, one)


def test_scan_epoch_qat(monkeypatch, voc_root, start):
    """QAT (the activation ranges move in each step) through the graphed
    engine: equal to the per-step path, and close to the JAX scan
    engine's QAT epoch."""
    from codenet_torch.models import create_model
    model = create_model("shufflenetv2", HEADS, 64, qspec=QuantSpec(),
                         device="cpu")
    model.load_state_dict(start, strict=False)
    qstart = model.state_dict()
    batches, _ = _batches(voc_root)
    scan = _port_epoch(monkeypatch, voc_root, qstart, batches, None, True,
                       qspec=QuantSpec())
    step = _port_epoch(monkeypatch, voc_root, qstart, batches, None, False,
                       qspec=QuantSpec())
    _assert_equal(scan, step)
    assert any(k.endswith("x_max") and float(v.abs().max()) > 0
               for k, v in scan[1].items())
    ref = _jax_epoch(monkeypatch, voc_root, qstart, batches, None,
                     qat=True)
    _assert_close_to_jax(scan, ref, qstart, qat=True)


def test_scan_epoch_handles_ragged_tail(monkeypatch, voc_root, start):
    """batch 3 over 8 images: the last batch (2) differs from the epoch's
    first and takes the per-step path; the epoch equals the per-step
    epoch."""
    batches, _ = _batches(voc_root, batch=3, drop_last=False)
    assert [T.batch_size_of(b) for b in batches] == [3, 3, 2]
    scan = _port_epoch(monkeypatch, voc_root, start, batches, None, True,
                       n_iters=-1)
    step = _port_epoch(monkeypatch, voc_root, start, batches, None, False,
                       n_iters=-1)
    _assert_equal(scan, step)
    assert np.isfinite(scan[0]["loss"])


def test_cli_main_trains_through_the_chunked_engine(monkeypatch, voc_root):
    """`cli.main` with no hook (--print_iter 0, its default) trains each
    epoch through the graphed engine; --print_iter 1 through the per-step
    path."""
    from codenet_torch.cli.main import main
    calls = []
    real = T.Trainer._run_epoch_scan

    def spy(self, *args):
        calls.append(args[1])
        return real(self, *args)
    monkeypatch.setattr(T.Trainer, "_run_epoch_scan", spy)
    monkeypatch.delenv("CODENET_SCAN_EPOCH", raising=False)
    args = ["ctdet", "--dataset", "pascal", "--arch", "shufflenetv2",
            "--input_res", "64", "--batch_size", "2", "--num_epochs", "2",
            "--num_iters", "2", "--val_intervals", "-1", "--num_workers",
            "1", "--gpus", "-1", "--data_dir", voc_root, "--exp_id",
            "torch_scan_cli"]
    main(args)
    assert calls == [2, 2]
    main(args + ["--print_iter", "1"])
    assert calls == [2, 2]
