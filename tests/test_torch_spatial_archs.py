"""--spatial_shard for res, resdcn, dlav0, dla and hourglass in the port
(each model's banded backbone, models/layers.py::band_plan and
run_steps) against one process and against the JAX package's ('data',
'spatial') mesh, and the deform backbone's gather ahead of its first
deform block.

Gloo ranks run on the CPU in JAX-free subprocesses
(tests/torch_spatial_archs_worker.py, started together: four ranks and
two) beside two `cli.main` ranks, and are held against the port in this
process (single-threaded, as the ranks are):

- the row windows these archs add (the 7x7 stride-2 stem, a 1x1
  stride-2 downsample through `layers.conv`'s module, the 3/2/1 and
  2/2/0 max pools through `max_pool_rows`) at spatial 2 and 4, on row
  bands, against plain torch on the whole map: output and dx, f64, 1e-10
  of each one's max;
- 2 FP32 steps of each arch (res_18, resdcn_18, dlav0_34, dla_34 at
  64^2; hourglass as the worker's narrow stand-in at 128^2) at batch 4
  from a conditioned init, at dp 1 x sp 2 and dp 2 x sp 2: every
  parameter and BN running statistic after the last step within 1e-8
  relative L2 in f64 (but the DCNv2 biases ahead of a train-mode BN,
  rounding noise in both runs, held with the whole state's 1e-8), the
  loss parts of each step within 1e-6 (the heads are f32), every rank's
  state bit-equal after each step;
- the gather points at sp 4, where 64^2 leaves the last stage 2 rows,
  and one dlav0_34 step there (1e-8);
- one step of ShuffleNetV2's deform backbone at dp 1 x sp 2, gathered
  ahead of layer1's first deform block (1e-8);
- one res_18 step at dp 1 x sp 2 with rank 1's neck statistics
  perturbed: the ranks end on rank 0's (bit-equal, 1e-8);
- `cli.main --arch res_18 --spatial_shard 2`, one two-step epoch on two
  gloo ranks under torchrun's variables through the epoch engine's step
  body, rank 0 ending in the final eval (the checkpoint write checks the
  ranks' states bit-equal).

And against the JAX package: the Trainer on get_mesh_2d(2,
devices=jax.devices()[:2]) from the same res_18 weights, two FP32 steps
of the port's dp 1 x sp 2 held at tests/test_parallel.py's tolerances
(rtol 5e-2, atol 3e-3). One JAX compile.
"""

import contextlib
import os
import shutil
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_spatial_archs_worker as A
from test_torch_spatial import (OP_TOL, STEP_LOSS_TOL, STEP_TOL,
                                assert_close, one_thread)

from codenet_tpu import config as jcfg
from codenet_tpu.engine.trainer import Trainer as JaxTrainer
from codenet_tpu.parallel import shard_batch
from codenet_tpu.parallel.mesh import get_mesh_2d
from codenet_torch.engine.jax_weights import (from_jax_variables,
                                              to_jax_variables)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "torch_spatial_archs_worker.py")
CLI_EXP = "torch_spatial_archs_cli"


def _cli_ranks(voc_root):
    """`cli.main --arch res_18 --spatial_shard 2` as two gloo ranks on
    the CPU under torchrun's variables: one data row of two spatial
    ranks, a two-step epoch at batch 2 through the epoch engine's step
    body, rank 0 ending in the final eval."""
    shutil.rmtree(os.path.join(REPO, "exp", "ctdet", CLI_EXP),
                  ignore_errors=True)
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = str(sock.getsockname()[1])
    cmd = [sys.executable, "-m", "codenet_torch.cli.main", "ctdet",
           "--dataset", "pascal", "--arch", "res_18", "--input_res", "64",
           "--gpus", "-1", "--spatial_shard", "2", "--data_dir", voc_root,
           "--exp_id", CLI_EXP, "--batch_size", "2", "--num_epochs", "1",
           "--num_iters", "2", "--val_intervals", "-1", "--num_workers",
           "1"]
    return [subprocess.Popen(
        cmd, cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True, env=dict(os.environ, PYTHONPATH=REPO, RANK=str(k),
                            LOCAL_RANK=str(k), WORLD_SIZE="2",
                            MASTER_ADDR="127.0.0.1", MASTER_PORT=port,
                            OMP_NUM_THREADS="1"))
        for k in range(2)]


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Every scenario's ranks and the CLI's, started together; meanwhile
    the one-process references and the JAX mesh's steps in this
    process."""
    from synthetic import make_voc_dataset
    voc = tmp_path_factory.mktemp("spatial_archs_voc")
    make_voc_dataset(str(voc), num_images=6, img_w=160, img_h=120)
    procs = {}
    for name in A.WORLDS:
        out = tmp_path_factory.mktemp(name)
        with open(out / "log", "w") as log:  # no pipe to fill while we wait
            procs[name] = (out, subprocess.Popen(
                [sys.executable, WORKER, name, str(out)], stdout=log,
                stderr=subprocess.STDOUT))
    cli = _cli_ranks(str(voc))
    with one_thread():
        refs = A.references()
    refs["jax"] = jax_mesh_2d_steps()
    got = {}
    for name, (out, proc) in procs.items():
        proc.wait(timeout=600)
        assert proc.returncode == 0, (out / "log").read_text()[-4000:]
        got[name] = []
        for k in range(A.WORLDS[name]):  # ~0.6 GB on rank 0: freed now
            path = os.path.join(out, "rank{}.pt".format(k))
            got[name].append(torch.load(path, weights_only=False))
            os.remove(path)
    outs = [p.communicate(timeout=600) for p in cli]
    got["cli"] = [(p.returncode,) + o for p, o in zip(cli, outs)]
    return got, refs


@pytest.mark.parametrize("spatial", [2, 4])
@pytest.mark.parametrize("op", list(A.OPS))
def test_halo_ops_match_the_whole_map(ranks, op, spatial):
    got, _ = ranks
    y, dx = A.op_reference(op)
    for r in got["archs4"]:
        res = r["ops_sp{}".format(spatial)][op]
        lo, hi = res["rows"]
        assert_close(res["y"], y, OP_TOL, (op, "y"))
        assert_close(res["dx"], dx[:, :, lo:hi], OP_TOL, (op, "dx"))


def assert_state_held(got, ref, noise, tol, what):
    """Every tensor of the state within `tol` relative L2 of its own norm,
    but the `noise` biases (torch_spatial_archs_worker.noise_biases:
    rounding noise in both runs), which count in the relative L2 of the
    whole state, also held within `tol`."""
    num = den = 0.0
    for k, v in ref.items():
        if not v.is_floating_point():
            assert torch.equal(got[k], v), (what, k)
            continue
        err = float((got[k].double() - v.double()).norm())
        norm = float(v.double().norm())
        num, den = num + err ** 2, den + norm ** 2
        if k not in noise:
            assert err <= tol * max(norm, 1e-30), (what, k, err)
    assert num ** 0.5 <= tol * den ** 0.5, (what, "state", num, den)


def _held(runs, ref, what):
    """The ranks' states bit-equal after each step (their digests), the
    loss parts of each step within STEP_LOSS_TOL of one process's, and
    rank 0's final state within STEP_TOL (assert_state_held)."""
    for i, stats in enumerate(runs[0]["stats"]):
        assert len({run["digests"][i] for run in runs}) == 1, (what, i)
        for k, v in ref["stats"][i].items():
            assert_close(stats[k], v, STEP_LOSS_TOL, (what, i, k))
    assert_state_held(runs[0]["state"], ref["state"], ref["noise"],
                      STEP_TOL, what)


@pytest.mark.parametrize("grid", ["archs2", "archs4"],
                         ids=["dp1xsp2", "dp2xsp2"])
@pytest.mark.parametrize("arch", list(A.ARCHS))
def test_steps_match_one_process(ranks, arch, grid):
    got, refs = ranks
    ref = refs[arch]
    _held([r[arch] for r in got[grid]], ref, arch)
    assert ref["moved"] > 0  # the BN statistics moved in step 2


@pytest.mark.parametrize("arch,cut", [("res_18", 5), ("dlav0_34", 5)])
def test_map_gathered_where_rows_stop_splitting(ranks, arch, cut):
    """64^2 at spatial 4: the last stage's output has 2 rows, so res_18
    gathers ahead of layer4, and dlav0_34 its levels 2-4 apiece and the
    input of level 5, which runs whole (one dlav0_34 step at dp 1 x sp 4
    held to one process)."""
    from codenet_torch.models.layers import gather_point
    got, refs = ranks
    if arch == "dlav0_34":
        _held([r["early"] for r in got["archs4"]], refs["dlav0_34_1"],
              arch)
    model = A.build(arch, A.case_opt(arch))
    steps = model.base.steps() if arch.startswith("dla") \
        else model._backbone_steps()
    assert gather_point(steps, A.RES, 4) == cut
    assert gather_point(steps, A.RES, 2) == len(steps)
    assert gather_point(steps, A.RES, 3) is None


@pytest.mark.parametrize("width,res,spatial,cut", [
    ("stand_in", 128, 2, 3), ("stand_in", 128, 4, 3),
    ("stand_in", 96, 4, 2), ("full", 512, 2, 3), ("full", 512, 4, 3),
    ("full", 128, 2, 2), ("full", 256, 4, 2), ("full", 72, 4, 1)])
def test_hourglass_stacks_run_on_bands_where_they_split(width, res,
                                                        spatial, cut):
    """The stacks run on bands (cut 3) where the kp modules' deepest rows
    split, else the map is gathered after the stem (2), or inside it
    where its own rows stop splitting (1): the stand-in's n = 2 kp
    modules bottom out at H/16, the full width's n = 5 at H/128 (built
    on the meta device: no weights)."""
    from codenet_torch.models.hourglass import HourglassNet
    from codenet_torch.models.layers import gather_point
    with torch.device("meta"):
        model = HourglassNet({"hm": 20}, 2, **(
            A.STAND_IN if width == "stand_in" else {}))
    assert gather_point(model._backbone_steps(), res, spatial) == cut


def test_deform_backbone_gathers_ahead_of_its_first_deform_block(ranks):
    from codenet_torch.models.layers import gather_point
    got, refs = ranks
    _held([r["deform"] for r in got["archs2"]], refs["deform_1"],
          "deform")
    model = A.build("deform", A.case_opt("deform"))
    steps = model._backbone_steps(False)
    assert gather_point(steps, A.RES, 2) == 1  # the stem alone on bands


def test_replicated_statistics_follow_the_rows_first_rank(ranks):
    """Rank 1 starts with its neck's BN running means 1e-12 off (they
    start at 0); after a step both ranks hold rank 0's, bit-equal,
    within 1e-8 of one process (parallel/mesh.py::
    sync_spatial_replicas)."""
    got, refs = ranks
    _held([r["sync"] for r in got["archs2"]], refs["res_18_1"], "sync")


def test_cli_trains_res_18_on_two_spatial_ranks(ranks):
    import json
    got, _ = ranks
    for rc, _, err in got["cli"]:
        assert rc == 0, err[-4000:]
    out0, out1 = got["cli"][0][1], got["cli"][1][1]
    assert "Mean AP" in out0 and "Mean AP" not in out1
    with open(os.path.join(REPO, "exp", "ctdet", CLI_EXP,
                           "scalars.jsonl")) as f:
        scalars = {r["tag"]: r["value"] for r in map(json.loads, f)}
    assert np.isfinite(scalars["train_loss"])


# -- against the JAX package ------------------------------------------------

def _jax_opt(*extra):
    args = ["ctdet", "--dataset", "pascal", "--arch", "res_18",
            "--input_res", str(A.RES), "--batch_size", str(A.GLOBAL_BATCH),
            "--gpus", "-1", *extra]
    return jcfg.update_dataset_info_and_set_heads(
        jcfg.parse(args), jcfg.DATASET_SPECS["pascal"])


def jax_mesh_2d_steps():
    """Two FP32 steps of the JAX Trainer on get_mesh_2d(2) over two
    devices (the input's H sharded over 'spatial') from the port's
    conditioned res_18 weights: each step's stats and the final
    variables."""
    mesh = get_mesh_2d(2, batch_size=A.GLOBAL_BATCH,
                       devices=jax.devices()[:2])
    jtr = JaxTrainer(_jax_opt("--spatial_shard", "2"), mesh=mesh)
    variables = jax.tree_util.tree_map(
        jnp.asarray, to_jax_variables(A.conditioned("res_18")))
    state = jtr.tx.init(variables["params"])
    out = {"stats": []}
    for batch in A.step_batches(A.STEPS):
        sb = shard_batch(mesh, batch)
        assert sb["input"].sharding.spec[1] == "spatial"
        variables, state, stats = jtr.train_step(variables, state, sb)
        out["stats"].append({k: float(v) for k, v in stats.items()})
    out["state"] = from_jax_variables(jax.tree_util.tree_map(
        np.asarray, dict(variables)))
    return out


def test_res_18_steps_match_jax_mesh_2d(ranks):
    """The port's dp 1 x sp 2 res_18 FP32 steps in f32 against the JAX
    mesh's (jax_mesh_2d_steps)."""
    got, refs = ranks
    port, ref = got["archs2"][0]["res_18_f32"], refs["jax"]
    for i, stats in enumerate(ref["stats"]):
        for k, v in stats.items():
            np.testing.assert_allclose(float(port["stats"][i][k]), v,
                                       rtol=5e-2, err_msg=k)
    for name, value in port["state"].items():
        if name.endswith("num_batches_tracked"):
            continue
        np.testing.assert_allclose(value.numpy(), ref["state"][name].numpy(),
                                   rtol=5e-2, atol=3e-3, err_msg=name)


@contextlib.contextmanager
def _one_jax_device():
    """jax.devices() as one device, for the JAX Trainer's default mesh."""
    from unittest import mock
    with mock.patch.object(jax, "devices",
                           lambda *a, **k: jax.local_devices()[:1]):
        yield


@pytest.mark.parametrize("arch", list(A.ARCHS))
def test_trainer_builds_the_grid_for_every_arch(ranks, arch):
    """--spatial_shard 2 on one process: the JAX Trainer and the port's
    raise the same ValueError (get_mesh_2d's), whatever the arch; on the
    ranks, the port's Trainer built its grid for every arch (rank,
    world, spatial, data rows)."""
    from codenet_torch.engine.trainer import Trainer
    got, _ = ranks
    with pytest.raises(ValueError) as jerr:
        with _one_jax_device():
            JaxTrainer(_jax_opt("--spatial_shard", "2", "--arch", arch))
    with pytest.raises(ValueError) as terr:
        Trainer(A.case_opt(arch, ["--spatial_shard", "2"]), device="cpu")
    assert str(terr.value) == str(jerr.value)
    for name, data_rows in (("archs2", 1), ("archs4", 2)):
        assert [r[arch]["grid"] for r in got[name]] == [
            (k, A.WORLDS[name], 2, data_rows)
            for k in range(A.WORLDS[name])]
