"""--spatial_shard in the port (codenet_torch/parallel/mesh.py's grid,
halo_rows and gather_rows; the banded backbone of
models/shufflenetv2.py) against one process and against the JAX
package's ('data', 'spatial') mesh.

Gloo ranks run on the CPU in JAX-free subprocesses
(tests/torch_spatial_worker.py, started together: four ranks, two and
three), and are held against the port in this process (single-threaded,
as the ranks are):

- each conv and pool of the backbone that reads across rows (the
  stride-4 stem, the stride-2 stem and its max pool, depthwise at
  stride 1 and 2, 1x1) at spatial 2 and 4, through the model's layers on
  row bands, against the op on the whole map: output and dx, f64, 1e-10
  of each one's max;
- 2 FP32 and 2 QAT steps of ShuffleNetV2-DCN 1x at 64^2, batch 4, from
  the conditioned init, at dp 1 x sp 2 and dp 2 x sp 2: every parameter,
  BN running statistic and QAT range after each step within 1e-8
  relative L2 in f64 (the loss parts within 1e-6: the heads are f32 in
  every mode, so partial sums of f32 terms round apart), every rank's
  state bit-equal;
- a step at dp 1 x sp 4, where layer3's two output rows do not split
  over 4 and the map is gathered ahead of it (1e-8);
- the colour aug of a band (the contrast's grey mean summed over the
  spatial group) against the whole image's rows (f32, 1e-6), a uint8
  step and a --device_cache_shard step (the warp of each rank's rows of
  its data row's shard) against one process in f32 (loss parts 1e-5,
  every tensor 1e-3 relative L2: f32 sums in another order);
- 64-row images at dp 1 x sp 3, which do not split: the JAX mesh's
  warning, and the batch run whole (1e-6 relative L2: 1/3 is not exact
  in binary, so each replicated gradient's three thirds round apart).

And against the JAX package: the grid's layout and its refusals against
get_mesh_2d, the one-process raise, and the Trainer on
get_mesh_2d(2, devices=jax.devices()[:2]) from the same weights: two
FP32 steps of the port's dp 1 x sp 2 held at tests/test_parallel.py's
tolerances (rtol 5e-2, atol 3e-3). One JAX compile.
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

import torch_parallel_worker as W
import torch_spatial_worker as S

from codenet_tpu import config as jcfg
from codenet_tpu.engine.trainer import Trainer as JaxTrainer
from codenet_tpu.parallel import shard_batch
from codenet_tpu.parallel.mesh import get_mesh_2d
from codenet_torch.engine.jax_weights import (from_jax_variables,
                                              to_jax_variables)

WORKER = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                      "torch_spatial_worker.py")
OP_TOL = 1e-10
STEP_TOL = 1e-8
STEP_LOSS_TOL = 1e-6


@contextlib.contextmanager
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Every scenario's ranks, started together; meanwhile the one-process
    references and the JAX mesh's steps in this process."""
    procs = {}
    for name in S.WORLDS:
        out = tmp_path_factory.mktemp(name)
        with open(out / "log", "w") as log:  # no pipe to fill while we wait
            procs[name] = (out, subprocess.Popen(
                [sys.executable, WORKER, name, str(out)], stdout=log,
                stderr=subprocess.STDOUT))
    with one_thread():
        refs = S.references()
    refs["jax"] = jax_mesh_2d_steps()
    got = {}
    for name, (out, proc) in procs.items():
        proc.wait(timeout=600)
        assert proc.returncode == 0, (out / "log").read_text()[-4000:]
        got[name] = [torch.load(os.path.join(out, "rank{}.pt".format(k)),
                                weights_only=False)
                     for k in range(S.WORLDS[name])]
    return got, refs


def assert_close(got, ref, tol, what):
    scale = max(float(ref.abs().max()), 1e-30)
    err = float((got - ref).abs().max())
    assert err <= tol * scale, (what, err, scale)


def assert_state(got, ref, tol, what):
    for k, v in ref.items():
        if not v.is_floating_point():
            assert torch.equal(got[k], v), (what, k)
            continue
        err = float((got[k].double() - v.double()).norm())
        assert err <= tol * max(float(v.double().norm()), 1e-30), \
            (what, k, err)


def assert_bit_equal(states, what):
    for other in states[1:]:
        for k, v in states[0].items():
            assert torch.equal(other[k], v), (what, k)


@pytest.mark.parametrize("spatial", [2, 4])
@pytest.mark.parametrize("op", list(S.OPS))
def test_halo_ops_match_the_whole_map(ranks, op, spatial):
    got, _ = ranks
    y, dx = S.op_reference(op)
    for r in got["grid4"]:
        res = r["ops_sp{}".format(spatial)][op]
        lo, hi = res["rows"]
        assert_close(res["y"], y, OP_TOL, (op, "y"))
        assert_close(res["dx"], dx[:, :, lo:hi], OP_TOL, (op, "dx"))


@pytest.mark.parametrize("grid,case", [
    ("grid2", "fp32"), ("grid2", "qat"), ("grid4", "fp32"),
    ("grid4", "qat")], ids=["dp1xsp2-fp32", "dp1xsp2-qat",
                            "dp2xsp2-fp32", "dp2xsp2-qat"])
def test_steps_match_one_process(ranks, grid, case):
    got, refs = ranks
    ref = refs[case]
    runs = [r[case] for r in got[grid]]
    for i, state in enumerate(ref["states"]):
        assert_bit_equal([run["states"][i] for run in runs], (case, i))
        assert_state(runs[0]["states"][i], state, STEP_TOL, (case, i))
        for k, v in ref["stats"][i].items():
            assert_close(runs[0]["stats"][i][k], v, STEP_LOSS_TOL, (i, k))
    moved = sum(float((ref["states"][-1][k] - v).abs().sum())
                for k, v in ref["states"][0].items()
                if k.endswith(("running_mean", "x_min", "x_max")))
    assert moved > 0  # the statistics of the mode moved in step 2


def test_map_gathered_where_rows_stop_splitting(ranks):
    """64^2 at spatial 4: layer3's output has 2 rows, so the bands are
    gathered ahead of layer3 and the rest runs whole on every rank."""
    got, refs = ranks
    runs = [r["early_gather"] for r in got["grid4"]]
    assert_bit_equal([run["states"][0] for run in runs], "early")
    assert_state(runs[0]["states"][0], refs["fp32"]["states"][0],
                 STEP_TOL, "early")
    from codenet_torch.models import create_model
    model = create_model("shufflenetv2", {"hm": 20, "wh": 2, "reg": 2},
                         64, device="cpu")
    steps = model._backbone_steps(False)
    assert model._gather_point(steps, W.RES, 4) == 3  # ahead of layer3
    assert model._gather_point(steps, W.RES, 2) == len(steps)
    assert model._gather_point(steps, W.RES, 3) is None


def test_band_colour_aug_takes_the_whole_images_grey_mean(ranks):
    from codenet_torch.data.device_aug import color_norm_f01
    got, _ = ranks
    images, perm, alphas, light = S.color_case()
    opt = W.task_opt()
    whole = color_norm_f01(images, perm, alphas, light, opt.mean, opt.std)
    for r in got["grid2"]:
        lo, hi = r["color"]["rows"]
        assert_close(r["color"]["out"], whole[:, lo:hi], 1e-6, "colour")


@pytest.mark.parametrize("grid,case", [("grid2", "u8"),
                                       ("grid4", "cache")])
def test_f32_input_paths_match_one_process(ranks, grid, case):
    """uint8 batches with colour aug (dp 1 x sp 2) and a
    --device_cache_shard step (dp 2 x sp 2, each data row's shard of the
    cache, each rank warping its band) against one process."""
    got, refs = ranks
    runs = [r[case] for r in got[grid]]
    if case == "cache":
        states = [run["state"] for run in runs]
        stats, ref_stats = runs[0]["stats"], refs[case]["stats"]
        ref_state = refs[case]["state"]
    else:
        states = [run["states"][0] for run in runs]
        stats = {k: float(v) for k, v in runs[0]["stats"][0].items()}
        ref_stats = {k: float(v) for k, v in refs[case]["stats"][0].items()}
        ref_state = refs[case]["states"][0]
    assert_bit_equal(states, case)
    for k, v in ref_stats.items():
        np.testing.assert_allclose(stats[k], v, rtol=1e-5, err_msg=k)
    assert_state(states[0], ref_state, 1e-3, case)


def test_rows_that_do_not_split_run_whole(ranks):
    got, refs = ranks
    runs = [r["whole"] for r in got["grid3"]]
    want = ("spatial_shard: image H=64 is not divisible by the spatial "
            "axis (3); 'input' is replicated over 'spatial' for this batch")
    for run in runs:
        assert run["warnings"] == [want]
    assert_bit_equal([run["states"][0] for run in runs], "whole")
    assert_state(runs[0]["states"][0], refs["fp32"]["states"][0], 1e-6,
                 "whole")


# -- against the JAX package ------------------------------------------------

@pytest.mark.parametrize("n,spatial,batch", [
    (8, 2, 8), (8, 4, 6), (8, 2, 6), (4, 4, 4), (6, 3, 4), (8, 8, 32)])
def test_grid_layout_matches_get_mesh_2d(n, spatial, batch):
    """grid_for_batch's data rows against get_mesh_2d's data axis, and
    rank d * spatial + s at the mesh's [d, s]."""
    from codenet_torch.parallel.mesh import grid_for_batch
    devices = jax.devices()[:n]
    mesh = get_mesh_2d(spatial, batch_size=batch, devices=devices)
    rows, sp = grid_for_batch(batch, n, spatial)
    assert (rows, sp) == (mesh.shape["data"], mesh.shape["spatial"])
    ids = np.array([d.id for d in devices[:rows * sp]])
    np.testing.assert_array_equal(
        np.vectorize(lambda d: d.id)(mesh.devices),
        ids.reshape(rows, sp))


@pytest.mark.parametrize("n,spatial", [(8, 3), (1, 2), (6, 4)])
def test_grid_refusals_match_get_mesh_2d(n, spatial):
    from codenet_torch.parallel.mesh import grid, grid_for_batch
    with pytest.raises(ValueError) as jerr:
        get_mesh_2d(spatial, devices=jax.devices()[:n])
    with pytest.raises(ValueError) as terr:
        grid_for_batch(8, n, spatial)
    assert str(terr.value) == str(jerr.value)
    if n == 1:
        with pytest.raises(ValueError) as one:
            grid(None, spatial)
        assert str(one.value) == str(jerr.value)


def test_one_process_raises_as_the_jax_trainer(ranks):
    """--spatial_shard 2 on one process: the JAX Trainer on one device
    and the port's Trainer raise the same ValueError. On two ranks
    another arch's Trainer builds its grid (rank, world, spatial, data
    rows), and the deform backbone runs its stem on bands and gathers
    ahead of layer1's first deform block (tests/
    test_torch_spatial_archs.py holds both against one process)."""
    from codenet_torch.engine.trainer import Trainer
    from codenet_torch.models import create_model
    jopt = _jax_opt("--spatial_shard", "2")
    with pytest.raises(ValueError) as jerr:
        with _one_jax_device():
            JaxTrainer(jopt)
    with pytest.raises(ValueError) as terr:
        Trainer(W.task_opt(extra=["--spatial_shard", "2"]), device="cpu")
    assert str(terr.value) == str(jerr.value)
    got, _ = ranks
    assert [r["res_18_grid"] for r in got["grid2"]] == [(0, 2, 2, 1),
                                                        (1, 2, 2, 1)]
    model = create_model("shufflenetv2", {"hm": 20}, 64,
                         deform_backbone=True, device="cpu")
    assert model._gather_point(model._backbone_steps(False), 64, 2) == 1


@contextlib.contextmanager
def _one_jax_device():
    """jax.devices() as one device, for the JAX Trainer's default mesh."""
    from unittest import mock
    with mock.patch.object(jax, "devices",
                           lambda *a, **k: jax.local_devices()[:1]):
        yield


def _jax_opt(*extra):
    args = ["ctdet", "--dataset", "pascal", "--arch", "shufflenetv2",
            "--input_res", str(W.RES), "--batch_size", str(W.GLOBAL_BATCH),
            "--gpus", "-1", *extra]
    return jcfg.update_dataset_info_and_set_heads(
        jcfg.parse(args), jcfg.DATASET_SPECS["pascal"])


def jax_mesh_2d_steps():
    """Two FP32 steps of the JAX Trainer on get_mesh_2d(2) over two
    devices (the input's H sharded over 'spatial') from the port's
    conditioned weights: each step's stats and the final variables."""
    mesh = get_mesh_2d(2, batch_size=W.GLOBAL_BATCH,
                       devices=jax.devices()[:2])
    jtr = JaxTrainer(_jax_opt("--spatial_shard", "2"), mesh=mesh)
    variables = jax.tree_util.tree_map(
        jnp.asarray, to_jax_variables(W.conditioned_state(W.task_opt())))
    state = jtr.tx.init(variables["params"])
    out = {"stats": []}
    for batch in S.step_batches(S.STEPS):
        sb = shard_batch(mesh, batch)
        assert sb["input"].sharding.spec[1] == "spatial"
        variables, state, stats = jtr.train_step(variables, state, sb)
        out["stats"].append({k: float(v) for k, v in stats.items()})
    out["state"] = from_jax_variables(jax.tree_util.tree_map(
        np.asarray, dict(variables)))
    return out


def test_steps_match_jax_mesh_2d(ranks):
    """The port's dp 1 x sp 2 FP32 steps in f32 against the JAX mesh's
    (jax_mesh_2d_steps)."""
    got, refs = ranks
    port, ref = got["grid2"][0]["fp32_f32"], refs["jax"]
    for i, stats in enumerate(ref["stats"]):
        for k, v in stats.items():
            np.testing.assert_allclose(float(port["stats"][i][k]), v,
                                       rtol=5e-2, err_msg=k)
    for name, value in port["states"][-1].items():
        if name.endswith("num_batches_tracked"):
            continue
        np.testing.assert_allclose(value.numpy(), ref["state"][name].numpy(),
                                   rtol=5e-2, atol=3e-3, err_msg=name)


@pytest.mark.parametrize("gpus,batch,want", [
    ("0,1,2,3", 4, ["cuda:0", "cuda:1", "cuda:2", "cuda:3"]),
    ("0,1,2,3", 3, ["cuda:0", "cuda:1"]),
    ("0,1", 5, ["cuda:0", "cuda:1"]),
    ("0,1,2", 4, None)])
def test_gpus_list_spawns_the_grid(monkeypatch, capsys, gpus, batch, want):
    """--gpus with --spatial_shard 2: spatial must divide the cards
    (ValueError, the JAX message), and the data axis shrinks until it
    divides the batch (a note), as get_mesh_2d's does."""
    from codenet_torch.cli import main as M
    calls = []
    monkeypatch.setattr(M, "launch", lambda fn, devices, args=():
                        calls.append(devices))
    opt = W.task_opt(extra=["--spatial_shard", "2"], batch=batch)
    opt.gpus_str = gpus
    opt.gpus = list(range(len(gpus.split(","))))
    if want is None:
        with pytest.raises(ValueError, match="does not divide the device"):
            M.train(opt)
        return
    assert M.train(opt) is None and calls == [want]
    n = len(gpus.split(","))
    assert ("does not divide over" in capsys.readouterr().out) == (
        len(want) < n)


@pytest.mark.parametrize("world,batch,match", [
    ("3", 4, "does not divide the device count 3"),
    ("4", 3, "does not divide over the 2 data rows")])
def test_torchrun_grid_refusals(monkeypatch, world, batch, match):
    from codenet_torch.parallel.mesh import join_from_env
    for k, v in (("RANK", "0"), ("LOCAL_RANK", "0"), ("WORLD_SIZE", world),
                 ("MASTER_ADDR", "127.0.0.1"), ("MASTER_PORT", "1")):
        monkeypatch.setenv(k, v)
    with pytest.raises(ValueError, match=match):
        join_from_env(batch, cpu=True, spatial=2)
