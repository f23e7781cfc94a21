"""The port's graphed epoch engine (engine/trainer.py::_run_epoch_scan)
on data-parallel and spatial ranks, against its per-step path and
against the JAX package's scan engine on its mesh.

Gloo ranks run on the CPU in JAX-free subprocesses
(tests/torch_parallel_worker.py and torch_spatial_worker.py, scenario
`engine`, started together) at 64^2, global batch 4, 3 steps from the
conditioned init. On the CPU the engine runs the step body per batch, so
every rank's engine epoch equals its per-step epoch bit for bit (meters
and state), FP32 and QAT (--wt-percentile --act_clamp) in f64, a
--device_cache_shard epoch, a ragged last global batch and a dp 1 x sp 2
grid; the ranks' states are bit-equal. Where the ranks would graph (an
NCCL rank on a card) they must take the same branch at every step: the
workers rerun the ragged epoch and the grid's with the graph branch
taken on the CPU by a stand-in that records each step it runs. A batch
that asks for another rank's cache rows raises on both ranks.

Against the JAX package: its Trainer.run_epoch (the scan engine, one
lax.scan over the 3 steps) on the 2-device CPU mesh of tests/conftest.py,
from the same weights (engine/jax_weights.py), against the port's 2-rank
engine epoch in f32 at test_torch_scan_epoch.py's tolerances: loss
meters, parameters and BN statistics within 5e-3, the updates within
5e-2 relative L2. One JAX compile.

And what a rank's step may not do inside a CUDA graph: on a one-rank
gloo group in this process, every task's loss with its backward and a
rank's FP32 and QAT step up to Adam read no value back to the host and
copy no host data to the device (a dispatch mode records both).

The card's NCCL rank is held in tests/test_torch_cuda.py and
chip_smoke.py's ddp phase.
"""

import contextlib
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from torch.utils._python_dispatch import TorchDispatchMode

import torch_parallel_worker as W

from codenet_tpu import config as jcfg
from codenet_tpu.engine.trainer import Trainer as JaxTrainer
from codenet_tpu.parallel import get_mesh
from codenet_torch.data.loader import DataLoader
from codenet_torch.engine.jax_weights import (from_jax_variables,
                                              to_jax_variables)
from codenet_torch.parallel.mesh import DataParallel

HERE = os.path.dirname(os.path.abspath(__file__))
WORKERS = {"dp": os.path.join(HERE, "torch_parallel_worker.py"),
           "grid": os.path.join(HERE, "torch_spatial_worker.py")}
JAX_TOL = 5e-3
JAX_UPDATE_TOL = 5e-2
ONE_PROCESS_TOL = 1e-5  # f32 sums over 2 ranks against one process


@contextlib.contextmanager
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


def _jax_epoch():
    """The JAX scan engine's epoch over the global batches on a 2-device
    mesh from the conditioned init: meters and final state (port
    names)."""
    args = ["ctdet", "--dataset", "pascal", "--arch", "shufflenetv2",
            "--input_res", str(W.RES), "--batch_size", str(W.GLOBAL_BATCH),
            "--gpus", "-1"]
    opt = jcfg.update_dataset_info_and_set_heads(
        jcfg.parse(args), jcfg.DATASET_SPECS["pascal"])
    jtr = JaxTrainer(opt, mesh=get_mesh(jax.devices()[:2]))
    jtr.variables = jax.tree_util.tree_map(
        jnp.asarray, to_jax_variables(W.conditioned_state(W.task_opt())))
    jtr.opt_state = jtr.tx.init(jtr.variables["params"])
    saved = os.environ.pop("CODENET_SCAN_EPOCH", None)
    try:
        stats = jtr.run_epoch("train", 1, W.step_batches(),
                              num_iters=W.STEPS)
    finally:
        if saved is not None:
            os.environ["CODENET_SCAN_EPOCH"] = saved
    return stats, from_jax_variables(jax.tree_util.tree_map(
        np.asarray, dict(jtr.variables)))


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Both workers' ranks, started together; meanwhile the JAX engine's
    epoch and the ragged epoch in one process, here."""
    procs = {}
    for name, worker in WORKERS.items():
        out = tmp_path_factory.mktemp("engine_" + name)
        with open(out / "log", "w") as log:  # no pipe to fill while we wait
            procs[name] = (out, subprocess.Popen(
                [sys.executable, worker, "engine", str(out)], stdout=log,
                stderr=subprocess.STDOUT))
    refs = {"jax": _jax_epoch()}
    with one_thread():
        refs["ragged"] = W.epoch_run(None, True, W.ragged_loader(None),
                                     dtype=torch.float32)
    got = {}
    for name, (out, proc) in procs.items():
        try:
            proc.wait(timeout=300)  # a rank that hangs fails the test
        except subprocess.TimeoutExpired:
            proc.kill()
            raise
        assert proc.returncode == 0, (out / "log").read_text()[-4000:]
        got[name] = [torch.load(out / "rank{}.pt".format(k),
                                weights_only=False) for k in range(2)]
    return got, refs


def assert_epochs_equal(a, b):
    assert a["stats"] == b["stats"]
    assert set(a["state"]) == set(b["state"])
    for k, v in b["state"].items():
        assert torch.equal(a["state"][k], v), k


def assert_ranks_equal(a, b):
    for k, v in a["state"].items():
        assert torch.equal(v, b["state"][k]), k


@pytest.mark.parametrize("case", ["fp32_f64", "qat_f64", "cache"])
def test_engine_epoch_matches_per_step(ranks, case):
    """Each rank's engine epoch (the engine ran: spy) equals its per-step
    epoch (it did not), meters and state bit for bit, and the ranks are
    bit-equal. 'cache': --device_cache_shard, each rank's batches asking
    for its own shard's rows, shifted to them before the step."""
    got, _ = ranks
    for r in got["dp"]:
        engine, per_step = r["engine"][case], r["per_step"][case]
        assert (engine["engine_calls"], per_step["engine_calls"]) == (1, 0)
        assert_epochs_equal(engine, per_step)
        assert np.isfinite(engine["stats"]["loss"])
    assert_ranks_equal(got["dp"][0]["engine"][case],
                       got["dp"][1]["engine"][case])


def test_qat_ranges_moved(ranks):
    got, _ = ranks
    state = got["dp"][0]["engine"]["qat_f64"]["state"]
    assert any(k.endswith("x_max") and float(v.abs().max()) > 0
               for k, v in state.items())


def test_foreign_cache_rows_raise(ranks):
    """A batch whose rows lie in the other rank's cache shard raises on
    both ranks, before any step (no rank waits in a collective)."""
    got, _ = ranks
    for r in got["dp"]:
        assert r["foreign"] is not None
        assert "shard ownership" in r["foreign"]


def test_ragged_tail_takes_the_per_step_path(ranks):
    """Global batches of 4, 4 and 3 through the port's DataLoader: rank 0
    holds 2 rows of the last, as of the others, rank 1 one. With the
    graph branch taken, both ranks run the first two batches through it
    and the last through the per-step path; the epoch ends, equals the
    per-step epoch, and its meters count the global batches: they and
    the state match one process's epoch over the whole batches."""
    got, refs = ranks
    for r in got["dp"]:
        assert r["ragged_graph_branch"]["graph_rows"] == [2, 2]
        assert_epochs_equal(r["engine"]["ragged"], r["per_step"]["ragged"])
        assert_epochs_equal(r["ragged_graph_branch"],
                            r["per_step"]["ragged"])
    a, b = (r["engine"]["ragged"] for r in got["dp"])
    assert_ranks_equal(a, b)
    ref = refs["ragged"]
    assert set(a["stats"]) == set(ref["stats"])
    for k, v in ref["stats"].items():
        np.testing.assert_allclose(a["stats"][k], v, rtol=ONE_PROCESS_TOL,
                                   err_msg=k)
    for k, v in ref["state"].items():
        if v.is_floating_point():
            err = float((a["state"][k] - v).norm())
            assert err <= 1e-3 * max(float(v.norm()), 1e-12), (k, err)


def test_grid_engine_epoch_matches_per_step(ranks):
    """dp 1 x sp 2 (--spatial_shard 2): the engine's epoch equals the
    per-step epoch; with the graph branch taken, every step of both
    ranks goes through it (the whole global batch of 4 on each rank of
    the one data row) and still equals it."""
    got, _ = ranks
    for r in got["grid"]:
        assert (r["engine"]["engine_calls"],
                r["per_step"]["engine_calls"]) == (1, 0)
        assert_epochs_equal(r["engine"], r["per_step"])
        assert r["graph_branch"]["graph_rows"] == [W.GLOBAL_BATCH] * 3
        assert_epochs_equal(r["graph_branch"], r["per_step"])
    assert_ranks_equal(got["grid"][0]["engine"], got["grid"][1]["engine"])


def test_engine_epoch_matches_jax_scan_engine(ranks):
    """The port's 2-rank engine epoch (f32) against the JAX scan engine on
    a 2-device mesh over the same global batches from the same weights:
    loss meters, every parameter and BN statistic within 5e-3, the
    parameter updates within 5e-2 relative L2."""
    got, refs = ranks
    port = got["dp"][0]["engine"]["fp32_f32"]
    jstats, jstate = refs["jax"]
    start = W.conditioned_state(W.task_opt())
    assert set(port["stats"]) == set(jstats)
    for k, v in jstats.items():
        np.testing.assert_allclose(port["stats"][k], v, rtol=JAX_TOL,
                                   err_msg=k)
    num = den = 0.0
    for k, ref in jstate.items():
        value = port["state"][k].numpy()
        np.testing.assert_allclose(value, ref.numpy(), rtol=JAX_TOL,
                                   atol=JAX_TOL, err_msg=k)
        if k.endswith(("weight", "bias")):
            du = value.astype(np.float64) - start[k].numpy()
            dj = ref.numpy().astype(np.float64) - start[k].numpy()
            num += float(((du - dj) ** 2).sum())
            den += float((dj ** 2).sum())
    assert den > 0 and (num / den) ** 0.5 <= JAX_UPDATE_TOL


@pytest.mark.parametrize("n,drop_last,sizes", [
    (11, False, [4, 4, 3]), (11, True, [4, 4]), (8, False, [4, 4])])
def test_loader_global_sizes(n, drop_last, sizes):
    """What every rank knows of each global batch, whatever rows it
    holds: the loader's global sizes, and its batches' rows."""
    loader = DataLoader(W.StepSet(n), W.GLOBAL_BATCH, shuffle=True,
                        num_workers=1, drop_last=drop_last, rows=(0, 2))
    assert loader.global_sizes() == sizes
    assert [len(b["input"]) for b in loader] == [min(s, 2) for s in sizes]


@pytest.mark.parametrize("backend,device,graphable", [
    ("nccl", "cuda:0", True), ("gloo", "cuda:0", False),
    ("gloo", "cpu", False)])
def test_graphable_ranks(backend, device, graphable):
    """Only an NCCL rank on a card graphs its steps: gloo's collectives
    run on the host."""
    dp = DataParallel(0, 2, torch.device(device), backend)
    assert dp.graphable is graphable


# -- capture safety: what a rank's step may not do inside a CUDA graph ------

class HostOps(TorchDispatchMode):
    """Records the ops that read a device value back to the host
    (`_local_scalar_dense`: .item(), float(t), bool(t)) or make a tensor
    from host data (`lift_fresh`: torch.tensor, new_tensor), neither of
    which a CUDA graph can capture; on the CPU they run all the same."""
    NAMES = ("aten._local_scalar_dense.default", "aten.lift_fresh.default")

    def __init__(self):
        super().__init__()
        self.seen = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if str(func) in self.NAMES:
            self.seen.append(str(func))
        return func(*args, **(kwargs or {}))


@pytest.fixture(scope="module")
def world1():
    """A one-rank gloo group in this process: every collective runs."""
    from codenet_torch.parallel.mesh import _free_port
    dist.init_process_group(
        "gloo", init_method="tcp://127.0.0.1:{}".format(_free_port()),
        rank=0, world_size=1)
    try:
        yield DataParallel(0, 1, torch.device("cpu"), "gloo")
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("case", list(W.TASKS))
def test_dp_losses_are_capture_safe(world1, case):
    """Every task's loss and its backward under `dp` (the global counts,
    --mse_loss and ddd's rotation bins included) neither reads a value
    back to the host nor copies host data to the device."""
    from codenet_torch.engine.trainer import LossOpts
    from codenet_torch.models.losses import LOSS_FACTORY
    opt, outs, batch = W.loss_case(case, "all")
    heads = {k: torch.from_numpy(v).float().requires_grad_()
             for k, v in outs.items()}
    targets = W.tensors(batch, torch.float32)
    with HostOps() as ops:
        loss, _ = LOSS_FACTORY[opt.task]([heads], targets,
                                         LossOpts(opt, world1))
        loss.backward()
    assert ops.seen == []


@pytest.mark.parametrize("qat", [False, True], ids=["fp32", "qat"])
def test_dp_step_is_capture_safe(world1, qat):
    """A rank's train step up to Adam (model input, the global-batch BNs,
    the QAT ranges by percentile, the loss, the gradient all-reduce, the
    stats' sum) neither reads a value back to the host nor copies host
    data to the device. Adam is left out: on the CPU it is torch's
    uncapturable one, on a card its capturable fused one."""
    from codenet_torch.engine.trainer import Trainer, batch_to_device
    from codenet_torch.models.layers import QuantSpec
    qspec = QuantSpec(wt_percentile=True, act_clamp=True) if qat else None
    trainer = Trainer(W.task_opt(), qspec=qspec, device="cpu", dp=world1)
    trainer.init()
    trainer.optimizer.step = lambda: None
    batch = batch_to_device(W.step_batches(1)[0], "cpu")
    with HostOps() as ops:
        stats = trainer.train_step(batch)
    assert ops.seen == []
    assert np.isfinite(float(stats["loss"]))
