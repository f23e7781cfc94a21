"""How the port's data-parallel ranks start and what each one loads,
against the JAX package's parallel/ and data/ modules.

- `world_for_batch` and `process_batch_slice` against the JAX package's
  `get_mesh_for_batch` and `process_batch_slice` over a table of cases;
- the loader's `shard_ranges` index batches against the JAX loader's, over
  seeds and epochs, and each rank's rows of every batch bit-equal to the
  one-process batch's (host, --host_normalize, cache and sharded-cache
  batches; ddd's here, multi_pose's and exdet's in their own files);
- `ImageCache.to_device(shard=True)`: each rank's rows, `shard_rows` and
  `shard_ranges` against the JAX cache's over a 1-8 device mesh, and the
  refusal of a dataset smaller than the group;
- `cli.main` then `cli.quant_main` as two gloo ranks on the CPU
  (``--gpus -1`` under torchrun's variables) against one process; the
  refusals (a world that does not divide the batch, cards without
  NCCL); ``--gpus 0,1,...`` spawning one rank per listed card;
- ``python -m codenet_torch.parallel.dryrun 2``.
"""

import os
import re
import socket
import subprocess
import sys
import types

import jax
import numpy as np
import pytest
import torch

from test_torch_common import assert_rank_rows_equal

from codenet_tpu.data.device_cache import ImageCache as JaxImageCache
from codenet_tpu.data.loader import DataLoader as JaxDataLoader
from codenet_tpu.parallel import get_mesh
from codenet_tpu.parallel import process_batch_slice as jax_slice
from codenet_tpu.parallel.mesh import get_mesh_for_batch
from codenet_torch import config as tcfg
from codenet_torch.data.datasets import get_dataset
from codenet_torch.data.device_cache import ImageCache
from codenet_torch.data.loader import DataLoader
from codenet_torch.parallel import (DataParallel, backend_for,
                                    process_batch_slice, world_for_batch)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")


def test_world_for_batch_matches_jax():
    devices = jax.devices()
    for batch in list(range(1, 18)) + [24, 30, 32, 64, 96]:
        for n in range(1, len(devices) + 1):
            want = get_mesh_for_batch(batch, devices[:n]).devices.size
            assert world_for_batch(batch, n) == want, (batch, n)


def test_process_batch_slice_matches_jax():
    for batch in (2, 4, 6, 8, 12, 32, 48):
        for world in range(1, 9):
            if batch % world:
                with pytest.raises(AssertionError):
                    jax_slice(batch, 0, world)
                with pytest.raises(ValueError):
                    process_batch_slice(batch, 0, world)
                continue
            for rank in range(world):
                assert process_batch_slice(batch, rank, world) == \
                    jax_slice(batch, rank, world)


class _Indices:
    def __init__(self, n):
        self.n = n

    def __len__(self):
        return self.n


@pytest.mark.parametrize("seed", [0, 7, 123])
def test_loader_shard_batches_match_jax(seed):
    """The same seed gives the same slot-block-routed index batches, epoch
    after epoch, for shards of equal and unequal sizes."""
    for n, batch, ranges in ((8, 4, [(0, 4), (4, 8)]),
                             (11, 4, [(0, 6), (6, 11)]),
                             (13, 6, [(0, 5), (5, 10), (10, 13)]),
                             (16, 8, [(0, 4), (4, 8), (8, 12), (12, 16)])):
        jl = JaxDataLoader(_Indices(n), batch, shuffle=True, seed=seed,
                           shard_ranges=ranges)
        tl = DataLoader(_Indices(n), batch, shuffle=True, seed=seed,
                        shard_ranges=ranges)
        assert len(jl) == len(tl) > 0
        for _ in range(3):
            a, b = jl._shard_batches(), tl._batches()
            assert len(a) == len(b) == len(tl)
            for x, y in zip(a, b):
                np.testing.assert_array_equal(x, y)


@pytest.fixture(scope="module")
def voc_root(tmp_path_factory):
    from synthetic import make_voc_dataset
    root = tmp_path_factory.mktemp("torch_multihost_voc")
    make_voc_dataset(str(root), num_images=8, img_w=160, img_h=120)
    return str(root)


def _voc_args(root, *extra, batch=4):
    return ["ctdet", "--dataset", "pascal", "--arch", "shufflenetv2",
            "--input_res", "64", "--batch_size", str(batch), "--gpus",
            "-1", "--data_dir", root, *extra]


def _voc_dataset(root, *extra):
    opt = tcfg.update_dataset_info_and_set_heads(
        tcfg.parse(_voc_args(root, *extra)), tcfg.DATASET_SPECS["pascal"])
    return get_dataset("pascal", "ctdet")(opt, "train")


@pytest.mark.parametrize("mode", ["host", "host_normalize", "cache",
                                  "cache_shard"])
def test_rank_rows_equal_one_process(voc_root, mode):
    """Every rank's rows of every batch, two epochs, bit-equal to the
    one-process batch: the warped uint8 input (or the f32 input of
    --host_normalize, or the cache's row index and warp matrix), the
    colour-aug state and every target."""
    extra = ["--host_normalize"] if mode == "host_normalize" else []
    dims = ImageCache.build(_voc_dataset(voc_root)).dims
    shard_ranges = None
    if mode == "cache_shard":
        cache = ImageCache(np.zeros((len(dims), 1, 1, 3), np.uint8), dims)
        cache.to_device("cpu", shard=True, dp=DataParallel(0, 2, CPU,
                                                            "gloo"))
        shard_ranges = cache.shard_ranges
        assert shard_ranges == [(0, 4), (4, 8)]

    def make():
        ds = _voc_dataset(voc_root, *extra)
        if mode.startswith("cache"):
            ds._image_cache_dims = dims
        return ds
    assert_rank_rows_equal(make, shard_ranges=shard_ranges)


def test_ddd_rank_rows_equal_one_process(tmp_path):
    """ddd's draws (--aug_ddd's scale and shift) replayed without the
    frame."""
    from synthetic_kitti import make_kitti_dataset
    make_kitti_dataset(str(tmp_path), num_images=4, img_w=256, img_h=96)
    args = ["ddd", "--dataset", "kitti", "--arch", "shufflenetv2",
            "--input_h", "96", "--input_w", "256", "--batch_size", "2",
            "--gpus", "-1", "--data_dir", str(tmp_path), "--aug_ddd", "0.7"]

    def make():
        opt = tcfg.update_dataset_info_and_set_heads(
            tcfg.parse(args), tcfg.DATASET_SPECS["kitti"])
        return get_dataset("kitti", "ddd")(opt, "train")
    assert_rank_rows_equal(make, batch_size=2, epochs=3)


def test_to_device_shard_matches_jax():
    """Rank r's card holds the JAX shard of device r: the rows, the
    zero-padded tail, `shard_rows` and `shard_ranges`; a dataset smaller
    than the group raises in both."""
    devices = jax.devices()
    r = np.random.RandomState(9)
    for n, d in ((8, 2), (9, 2), (7, 3), (5, 4), (8, 8), (9, 8), (1, 1)):
        images = r.randint(0, 256, (n, 3, 2, 3)).astype(np.uint8)
        dims = np.full((n, 2), 3, np.int32)
        jc = JaxImageCache(images.copy(), dims)
        arr = jc.to_device(get_mesh(devices[:d]), shard=True)
        shards = {s.device: np.asarray(s.data)
                  for s in arr.addressable_shards}
        for rank in range(d):
            tc = ImageCache(images.copy(), dims)
            rows = tc.to_device("cpu", shard=True,
                                dp=DataParallel(rank, d, CPU, "gloo"))
            assert tc.shard_rows == jc.shard_rows
            assert tc.shard_ranges == jc.shard_ranges
            np.testing.assert_array_equal(rows.numpy(),
                                          shards[devices[rank]])
    for d in (2, 4):
        with pytest.raises(ValueError, match="smaller"):
            JaxImageCache(np.zeros((1, 2, 2, 3), np.uint8),
                          np.ones((1, 2), np.int32)).to_device(
                get_mesh(devices[:d]), shard=True)
        with pytest.raises(ValueError, match="smaller"):
            ImageCache(np.zeros((1, 2, 2, 3), np.uint8),
                       np.ones((1, 2), np.int32)).to_device(
                "cpu", shard=True, dp=DataParallel(0, d, CPU, "gloo"))


# -- how ranks start ---------------------------------------------------------

def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _losses(text):
    return [float(line.split(" loss ")[1].split()[0])
            for line in text.splitlines() if line.startswith("train epoch")]


def _run_cli(module, args, ranks):
    """`python -m module args` as one process (ranks 0) or as `ranks` gloo
    ranks under torchrun's variables; the outputs, rank 0's first."""
    env = dict(os.environ, PYTHONPATH=REPO)
    if not ranks:
        proc = subprocess.run([sys.executable, "-m", module, *args], env=env,
                              capture_output=True, text=True, timeout=600,
                              cwd=REPO)
        assert proc.returncode == 0, proc.stderr[-4000:]
        return [proc.stdout]
    port = str(_free_port())
    procs = [subprocess.Popen(
        [sys.executable, "-m", module, *args], cwd=REPO,
        env=dict(env, RANK=str(k), LOCAL_RANK=str(k),
                 WORLD_SIZE=str(ranks), MASTER_ADDR="127.0.0.1",
                 MASTER_PORT=port),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for k in range(ranks)]
    outs = [p.communicate(timeout=600) for p in procs]
    for p, (_, err) in zip(procs, outs):
        assert p.returncode == 0, err[-4000:]
    return [out for out, _ in outs]


def test_cli_two_ranks_write_the_one_process_checkpoint(voc_root):
    """cli.main (2 FP32 steps at global batch 4 from the conditioned init,
    a checkpoint it loads; then the final eval) and cli.quant_main from
    its checkpoint (2 QAT steps), each as two gloo ranks and as one
    process. Rank 0 alone prints, logs and evaluates, and the checkpoints
    match the one-process ones: same keys, epoch, recipe and Adam step
    count; the first FP32 step's loss to the printed 4 decimals (the
    same weights, the batch split), the first QAT step's within 1e-3;
    the rest within what f32 sums taken in another order
    allow after 2 + 2 Adam steps: parameters 2 lr a step (Adam moves an
    element whose gradient is rounding noise by lr either way), BN
    statistics 1e-3 of their scale (a running mean by the channel's std,
    a variance relative), QAT range bounds 1e-2 of the larger bound's
    magnitude (an extreme of the activations after weights that may
    differ so; measured up to 1.7e-3; the deform blocks' scale
    quantizers see s ~ 1 with a range a few lr wide, so the width is no
    scale)."""
    from codenet_torch.engine.checkpoint import save_model
    from torch_parallel_worker import conditioned_state, task_opt
    start = os.path.join(voc_root, "conditioned.pth")
    model = types.SimpleNamespace(state_dict=lambda: conditioned_state(
        task_opt()))
    save_model(start, 0, model)
    common = ["--num_epochs", "1", "--num_iters", "2", "--val_intervals",
              "-1", "--num_workers", "1", "--print_iter", "1"]
    ckpts = {}
    for ranks in (2, 0):
        tag = "torch_dp{}".format(ranks)
        fp32 = _run_cli("codenet_torch.cli.main",
                        _voc_args(voc_root, *common, "--exp_id", tag + "a",
                                  "--load_model", start), ranks)
        qat = _run_cli("codenet_torch.cli.quant_main",
                       _voc_args(voc_root, *common, "--exp_id", tag + "b",
                                 "--wt-percentile", "--act_clamp",
                                 "--load_model",
                                 os.path.join(REPO, "exp", "ctdet",
                                              tag + "a", "model_last.pth")),
                       ranks)
        for out in (fp32, qat):
            assert len(_losses(out[0])) == 2 and "Mean AP" in out[0]
            for rest in out[1:]:
                assert _losses(rest) == [] and "Mean AP" not in rest
        ckpts[ranks] = [torch.load(os.path.join(
            REPO, "exp", "ctdet", tag + s, "model_last.pth"))
            for s in "ab"]
        ckpts[ranks].append((_losses(fp32[0]), _losses(qat[0])))
    lr = 1.25e-4
    for got, ref, steps in zip(ckpts[2][:2], ckpts[0][:2], (2, 4)):
        assert got["epoch"] == ref["epoch"] == 1
        assert got.get("quant") == ref.get("quant")
        counts = [st["step"] for st in got["optimizer"]["state"].values()]
        assert set(map(float, counts)) == {2.0}
        assert set(got["state_dict"]) == set(ref["state_dict"])
        sd, gd = ref["state_dict"], got["state_dict"]
        for k, v in sd.items():
            g = gd[k]
            # statistics in the units of their spread: a running mean
            # near 0 by the channel's std, a range by its width
            if k.endswith("running_mean"):
                spread = sd[k[:-4] + "var"].sqrt()
            elif k.endswith(("x_min", "x_max")):
                spread = torch.maximum(sd[k[:-3] + "max"].abs(),
                                       sd[k[:-3] + "min"].abs())
            elif k.endswith("running_var"):
                spread = v
            if k.endswith(("running_mean", "running_var", "x_min",
                           "x_max")):
                err = float(((g - v).abs() / spread).max())
                assert err <= (1e-2 if k.endswith("x_min") or k.endswith(
                    "x_max") else 1e-3), (k, err)
            elif v.is_floating_point():
                np.testing.assert_allclose(g.numpy(), v.numpy(), rtol=0,
                                           atol=2 * steps * lr + 1e-6,
                                           err_msg=k)
            else:
                assert torch.equal(g, v), k
    (f_got, q_got), (f_ref, q_ref) = ckpts[2][2], ckpts[0][2]
    # printed with 4 decimals
    np.testing.assert_allclose(f_got[0], f_ref[0], rtol=0, atol=1e-4)
    np.testing.assert_allclose(q_got[0], q_ref[0], rtol=1e-3)


def test_torchrun_world_must_divide_the_batch(monkeypatch, voc_root):
    from codenet_torch.cli.main import main
    for k, v in (("RANK", "0"), ("LOCAL_RANK", "0"), ("WORLD_SIZE", "3"),
                 ("MASTER_ADDR", "127.0.0.1"), ("MASTER_PORT", "1")):
        monkeypatch.setenv(k, v)
    with pytest.raises(ValueError, match="does not divide over the 3"):
        main(_voc_args(voc_root, "--num_epochs", "1"))


def test_cards_need_nccl(monkeypatch):
    """Between cards the backend is NCCL; without it, launching raises
    before any process starts (no quiet switch to gloo)."""
    import torch.distributed as dist
    assert backend_for("cpu") == "gloo"
    monkeypatch.setattr(dist, "is_nccl_available", lambda: False)
    with pytest.raises(RuntimeError, match="NCCL"):
        backend_for("cuda:0")
    from codenet_torch.parallel import launch
    with pytest.raises(RuntimeError, match="NCCL"):
        launch(print, ["cuda:0", "cuda:1"])


@pytest.mark.parametrize("gpus,batch,want", [
    ("0,1", 4, ["cuda:0", "cuda:1"]),
    ("0,1,2", 4, ["cuda:0", "cuda:1"]),
    ("2,3", 6, ["cuda:2", "cuda:3"]),
    ("0,1,2", 5, [])])
def test_gpus_list_spawns_one_rank_per_card(monkeypatch, capsys, voc_root,
                                           gpus, batch, want):
    """--gpus lists the cards (the reference's ids); the world shrinks to
    the largest count that divides the batch, with a note, as the JAX
    package's get_mesh_for_batch does; a world of one trains in this
    process."""
    from codenet_torch.cli import main as M
    calls = []
    monkeypatch.setattr(M, "launch", lambda fn, devices, args=(): calls.append(
        (fn, devices, args)))
    monkeypatch.setattr(M, "run_training",
                        lambda opt, qspec=None, dp=None: "one process")
    opt = tcfg.parse(_voc_args(voc_root, batch=batch)[:-4]
                     + ["--gpus", gpus, "--data_dir", voc_root])
    got = M.train(opt)
    if not want:
        assert got == "one process" and not calls
    else:
        assert got is None and calls[0][1] == want
        assert calls[0][0] is M._rank_main
    n = len(gpus.split(","))
    shrunk = bool(want) and len(want) < n or not want
    assert ("does not divide over {} cards".format(n)
            in capsys.readouterr().out) == shrunk


def test_dryrun_two_ranks():
    proc = subprocess.run(
        [sys.executable, "-m", "codenet_torch.parallel.dryrun", "2"],
        capture_output=True, text=True, timeout=300, cwd=REPO,
        env=dict(os.environ, PYTHONPATH=REPO))
    assert proc.returncode == 0, proc.stderr[-4000:]
    lines = proc.stdout.splitlines()
    assert len(lines) == 3, lines
    assert re.match(r"dryrun\(2\): dp loss=[\d.]+ OK", lines[0])
    assert re.match(r"dryrun\(2\): dp x sp loss=[\d.]+ OK", lines[1])
    assert re.match(r"dryrun\(2\): dp \+ sharded-cache loss=[\d.]+ OK",
                    lines[2])


def test_quiet_ranks_print_nothing():
    """Only rank 0 prints: the other ranks' stdout goes nowhere."""
    from codenet_torch.cli.main import _quiet_unless_main
    import contextlib
    import io
    for rank, want in ((0, "x\n"), (1, "")):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            with _quiet_unless_main(types.SimpleNamespace(main=rank == 0)):
                print("x")
        assert buf.getvalue() == want
