"""The port's FP32 training path against the JAX package.

Held against the JAX functions on the same seeded numpy inputs: the ctdet
loss (values and gradients), the device-side colour augmentation for all
six op orders, the heatmap rendering, the sampler and the loader on a
synthetic VOC set, and one train step of the full ShuffleNetV2-DCN 1x
model (64^2, batch 2, a sampler batch): loss, every gradient, BN running
statistics and the Adam-updated parameters. The JAX side runs its
`make_train_step` on its XLA deform path (the port's plain deform
backward is held against the Pallas backward in test_torch_deform.py).
Last, `python -m codenet_torch.cli.main` trains on the CPU.
"""

import os
import types

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from test_torch_common import (HEADS, assert_train_step_matches_jax,
                               raise_bn_biases, rng, to_np)

from codenet_tpu import config as jcfg
from codenet_tpu.data import device_aug as JA
from codenet_tpu.data.datasets import get_dataset as jax_get_dataset
from codenet_tpu.data.loader import DataLoader as JaxDataLoader
from codenet_tpu.engine.trainer import Trainer as JaxTrainer
from codenet_tpu.models import losses as JL
from codenet_torch import config as tcfg
from codenet_torch.data import device_aug as TA
from codenet_torch.data.affine import invert_affine, warp_affine_u8
from codenet_torch.data.datasets import get_dataset
from codenet_torch.data.loader import DataLoader
from codenet_torch.engine.trainer import Trainer
from codenet_torch.models import losses as TL

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LR = 1.25e-4


# -- losses -----------------------------------------------------------------

def _loss_opt(**kw):
    opt = dict(mse_loss=False, dense_wh=False, cat_spec_wh=False,
               norm_wh=False, reg_loss="l1", reg_offset=True, hm_weight=1.0,
               wh_weight=0.1, off_weight=1.0)
    opt.update(kw)
    return types.SimpleNamespace(**opt)


@pytest.mark.parametrize("case", ["l1", "sl1", "norm_wh", "cat_spec_wh",
                                  "no_positive"])
def test_ctdet_loss_matches_jax(case):
    """Loss, its parts and its gradient w.r.t. the head outputs; the
    no-positive case takes the focal loss's num_pos == 0 branch."""
    r = rng(40)
    n, h, w, c, m = 2, 8, 8, 20, 6
    opt = _loss_opt(reg_loss="sl1" if case == "sl1" else "l1",
                    norm_wh=case == "norm_wh",
                    cat_spec_wh=case == "cat_spec_wh")
    wh_ch = 2 * c if opt.cat_spec_wh else 2
    outs = {"hm": r.randn(n, h, w, c), "wh": r.randn(n, h, w, wh_ch) * 4,
            "reg": r.rand(n, h, w, 2)}
    outs = {k: v.astype(np.float32) for k, v in outs.items()}
    hm = (r.rand(n, h, w, c) * 0.9).astype(np.float32)
    if case != "no_positive":
        hm[0, 2, 3, 4] = hm[1, 5, 1, 0] = hm[1, 6, 6, 19] = 1.0
    batch = {"hm": hm,
             "reg_mask": (np.arange(m) < 3).astype(np.uint8)[None]
             .repeat(n, 0),
             "ind": r.randint(0, h * w, (n, m)).astype(np.int64),
             "wh": r.uniform(1, 9, (n, m, 2)).astype(np.float32),
             "reg": r.rand(n, m, 2).astype(np.float32),
             "cat_spec_wh": r.uniform(1, 9, (n, m, 2 * c)).astype(np.float32),
             "cat_spec_mask": (r.rand(n, m, 2 * c) < 0.2).astype(np.uint8)}

    def jloss(o):
        return JL.ctdet_loss([o], {k: jnp.asarray(v)
                                   for k, v in batch.items()}, opt)

    (ref, rstats), rgrad = jax.value_and_grad(jloss, has_aux=True)(
        {k: jnp.asarray(v) for k, v in outs.items()})
    touts = {k: torch.from_numpy(v).requires_grad_() for k, v in outs.items()}
    loss, stats = TL.ctdet_loss([touts], {k: torch.from_numpy(v)
                                          for k, v in batch.items()}, opt)
    loss.backward()
    for k in ("loss", "hm_loss", "wh_loss", "off_loss"):
        np.testing.assert_allclose(float(stats[k].detach()), float(rstats[k]),
                                   rtol=1e-5, atol=1e-7, err_msg=k)
    for k in outs:
        np.testing.assert_allclose(to_np(touts[k].grad),
                                   np.asarray(rgrad[k]), rtol=1e-4,
                                   atol=1e-7, err_msg=k)


# -- device-side augmentation and targets -----------------------------------

@pytest.mark.parametrize("perm", range(6))
def test_color_aug_matches_jax(perm):
    """Colour aug + normalisation in each of the 6 op orders (the second
    image of the batch takes the next order)."""
    r = rng(41 + perm)
    img = r.randint(0, 256, (2, 16, 12, 3)).astype(np.uint8)
    perms = np.array([perm, (perm + 1) % 6], np.int32)
    alphas = r.uniform(-0.4, 0.4, (2, 3)).astype(np.float32)
    light = (r.randn(2, 3) * 0.05).astype(np.float32)
    mean, std = [0.485, 0.456, 0.406], [0.229, 0.224, 0.225]
    ref = JA.device_preprocess(jnp.asarray(img), jnp.asarray(perms),
                               jnp.asarray(alphas), jnp.asarray(light),
                               mean, std)
    out = TA.device_preprocess(torch.from_numpy(img),
                               torch.from_numpy(perms),
                               torch.from_numpy(alphas),
                               torch.from_numpy(light), mean, std)
    np.testing.assert_allclose(to_np(out), np.asarray(ref), rtol=1e-5,
                               atol=1e-5)


def test_color_aug_draws_match_jax():
    from codenet_torch.data.datasets import BaseDataset
    ev, evec = BaseDataset._eig_val, BaseDataset._eig_vec
    a = JA.draw_color_aug_params(np.random.RandomState(3), ev, evec,
                                 py_random=np.random.RandomState(4))
    b = TA.draw_color_aug_params(np.random.RandomState(3), ev, evec,
                                 py_random=np.random.RandomState(4))
    assert a[0] == b[0]
    np.testing.assert_array_equal(a[1], b[1])
    np.testing.assert_array_equal(a[2], b[2])


def test_render_umich_hm_matches_jax():
    r = rng(48)
    b, m, oh, ow, c = 2, 7, 16, 12, 5
    ct = np.stack([r.randint(0, ow, (b, m)), r.randint(0, oh, (b, m))],
                  -1).astype(np.int32)
    radius = r.randint(0, 5, (b, m)).astype(np.int32)
    cls = r.randint(0, c, (b, m)).astype(np.int32)
    mask = (r.rand(b, m) < 0.7).astype(np.uint8)
    ref = JA.render_umich_hm(jnp.asarray(ct), jnp.asarray(radius),
                             jnp.asarray(cls), jnp.asarray(mask), oh, ow, c)
    out = TA.render_umich_hm(torch.from_numpy(ct), torch.from_numpy(radius),
                             torch.from_numpy(cls), torch.from_numpy(mask),
                             oh, ow, c)
    np.testing.assert_allclose(to_np(out), np.asarray(ref), rtol=1e-6,
                               atol=1e-7)
    assert float(out.max()) == 1.0


# -- sampler and loader -----------------------------------------------------

@pytest.fixture(scope="module")
def voc_root(tmp_path_factory):
    from synthetic import make_voc_dataset
    root = tmp_path_factory.mktemp("torch_train_voc")
    make_voc_dataset(str(root), num_images=6, img_w=160, img_h=120)
    return str(root)


def _opt(cfg, voc_root, extra=()):
    args = ["ctdet", "--dataset", "pascal", "--arch", "shufflenetv2",
            "--input_res", "64", "--batch_size", "2", "--gpus", "-1",
            "--data_dir", voc_root] + list(extra)
    return cfg.update_dataset_info_and_set_heads(
        cfg.parse(args), cfg.DATASET_SPECS["pascal"])


def _datasets(voc_root, split):
    return (jax_get_dataset("pascal", "ctdet")(_opt(jcfg, voc_root), split),
            get_dataset("pascal", "ctdet")(_opt(tcfg, voc_root), split))


def _port_warp_in_jax_sampler(monkeypatch):
    """Give the JAX sampler the port's warp in place of cv2.warpAffine,
    so that whole samples can be compared exactly."""
    from codenet_tpu.data import samplers as JS
    real = JS.cv2

    def warp(img, trans, size, flags=None):
        return warp_affine_u8(img, invert_affine(trans), size[1], size[0])

    monkeypatch.setattr(JS, "cv2", types.SimpleNamespace(
        imread=real.imread, warpAffine=warp,
        INTER_LINEAR=real.INTER_LINEAR))


def _assert_samples_equal(a, b, skip=()):
    assert set(a) == set(b)
    for k in a:
        if k in skip:
            continue
        if k == "meta":
            for mk in ("c", "s", "gt_det", "img_id"):
                np.testing.assert_array_equal(a[k][mk], b[k][mk],
                                              err_msg=mk)
            continue
        assert np.asarray(a[k]).dtype == np.asarray(b[k]).dtype, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.parametrize("split", ["train", "val"])
def test_sampler_matches_jax(voc_root, monkeypatch, split):
    """Same RandomState, same sample: crop, flip, colour-aug state and
    every target, and (with the port's warp in both) the image."""
    _port_warp_in_jax_sampler(monkeypatch)
    jds, tds = _datasets(voc_root, split)
    assert len(jds) == len(tds) == 6
    for i in range(len(tds)):
        _assert_samples_equal(
            jds.get_sample(i, rng=np.random.RandomState(50 + i)),
            tds.get_sample(i, rng=np.random.RandomState(50 + i)))


def test_sampler_image_against_cv2(voc_root):
    """Against the JAX sampler's real cv2.warpAffine: every target equal,
    and the image within 8 levels with 99% of the values within 1 level.
    Measured with OpenCV 5.0: identical (max difference 0). The bound
    allows for OpenCV builds that snap coordinates to 1/32 px and
    interpolate uint8 in fixed point: the synthetic boxes' edges step by
    up to ~200 levels, so 1/32 px moves an edge pixel by ~6."""
    jds, tds = _datasets(voc_root, "train")
    for i in range(len(tds)):
        a = jds.get_sample(i, rng=np.random.RandomState(60 + i))
        b = tds.get_sample(i, rng=np.random.RandomState(60 + i))
        _assert_samples_equal(a, b, skip=("input_u8",))
        diff = np.abs(a["input_u8"].astype(np.int32)
                      - b["input_u8"].astype(np.int32))
        assert diff.max() <= 8, diff.max()
        assert (diff <= 1).mean() >= 0.99, (diff <= 1).mean()


def test_loader_matches_jax(voc_root, monkeypatch):
    """Same seed: the same shuffled batch order and per-batch streams over
    two epochs, at different worker counts."""
    _port_warp_in_jax_sampler(monkeypatch)
    jds, tds = _datasets(voc_root, "train")
    jl = JaxDataLoader(jds, 2, shuffle=True, num_workers=2, seed=7)
    tl = DataLoader(tds, 2, shuffle=True, num_workers=3, seed=7)
    assert len(jl) == len(tl) == 3
    for _ in range(2):
        batches = list(zip(jl, tl))
        assert len(batches) == 3
        for a, b in batches:
            _assert_samples_equal(a, b)


# -- one FP32 train step of the full model ----------------------------------

def test_train_step_matches_jax(voc_root):
    """Both packages start from the port's seeded init (s == 1 in every
    deform block: integer sampling coordinates) with every BN bias but
    those before the heads' last convs raised by 3, and take one Adam step
    on the same uint8 sampler batch; the JAX side is its make_train_step
    on its XLA deform path.

    The raised biases put nearly every ReLU on its linear side. At the
    init's zero biases a random network ~60 layers deep with train-mode
    BN is chaotic in f32: measured with tools_torch/step_conditioning.py
    --res 64 --batch 2 (CPU, chip_smoke.py's frames), its f32 gradients
    differ from its f64 ones by 0.94% (relative L2; median tensor 0.78%,
    worst 6.6%); from the raised biases by 2.4e-6 (median 9.9e-6, worst
    2.3e-4). The BNs before the heads' last convs keep their biases, so
    the heatmap logits stay off the loss's sigmoid clamp. So the loss
    parts are held at the forward tolerance (2e-3); each gradient (read
    from the JAX side's first Adam moment, mu = 0.1 g) within 5e-3 of its
    max; BN running statistics within 1e-3. Adam's first step moves each
    parameter by about lr * sign(g), so updated parameters are held at
    2 lr."""
    tds = get_dataset("pascal", "ctdet")(_opt(tcfg, voc_root), "train")
    batch = next(iter(DataLoader(tds, 2, shuffle=True, num_workers=1,
                                 seed=3)))
    assert int(batch["reg_mask"].sum()) >= 1
    trainer = Trainer(_opt(tcfg, voc_root), device="cpu")
    trainer.init()
    raise_bn_biases(trainer.model, HEADS)
    jtr = JaxTrainer(_opt(jcfg, voc_root))
    jtr.init()
    assert_train_step_matches_jax(trainer, jtr, batch, LR)


# -- the training CLI ---------------------------------------------------------

def test_cli_main_trains_saves_and_drops_lr(voc_root, capsys):
    """python -m codenet_torch.cli.main on the CPU: 1 epoch of 2
    iterations, a checkpoint with the optimizer, the LR drop at
    --lr_step 1, and the final detection eval."""
    from codenet_torch.cli.main import main
    exp_id = "torch_train_cli"
    main(["ctdet", "--dataset", "pascal", "--arch", "shufflenetv2",
          "--input_res", "64", "--batch_size", "2", "--num_epochs", "1",
          "--num_iters", "2", "--lr_step", "1", "--val_intervals", "-1",
          "--num_workers", "1", "--print_iter", "1", "--gpus", "-1",
          "--data_dir", voc_root, "--exp_id", exp_id])
    out = capsys.readouterr().out
    losses = [float(line.split(" loss ")[1].split()[0])
              for line in out.splitlines() if line.startswith("train epoch")]
    assert len(losses) == 2 and np.all(np.isfinite(losses))
    assert "Drop LR to {}".format(LR * 0.1) in out
    assert "Mean AP" in out
    save_dir = os.path.join(REPO, "exp", "ctdet", exp_id)
    for name in ("model_last.pth", "model_1.pth", "opt.txt",
                 "scalars.jsonl"):
        assert os.path.exists(os.path.join(save_dir, name)), name
    payload = torch.load(os.path.join(save_dir, "model_last.pth"),
                         weights_only=True)
    assert payload["epoch"] == 1 and "quant" not in payload
    assert payload["optimizer"]["param_groups"][0]["lr"] == LR
    assert set(payload["state_dict"]) == set(
        Trainer(_opt(tcfg, voc_root), device="cpu").model.state_dict())


PORTED_TRAINING_OPTIONS = (["--host_normalize"], ["--device_cache"],
                           ["--dtype", "bfloat16"], ["--debug", "1"],
                           ["--eval_oracle_hm"], ["--test"],
                           ["--device_cache_shard"], ["--mse_loss"],
                           ["--dense_wh"], ["--trace"])


def _scalars(exp_id):
    import json
    path = os.path.join(REPO, "exp", "ctdet", exp_id, "scalars.jsonl")
    with open(path) as f:
        return {r["tag"]: r["value"] for r in map(json.loads, f)}


@pytest.mark.parametrize("extra", [
    ["--debug", "1"], ["--eval_oracle_hm"], ["--spatial_shard", "2"],
    ["--host_normalize"], ["--mse_loss"], ["--dense_wh"],
    ["--device_cache"], ["--test"], ["--trace"], ["--dtype", "bfloat16"],
    ["--device_cache_shard"]])
def test_unported_training_options_raise(extra, voc_root, capsys,
                                        monkeypatch):
    """Options of the JAX trainer and sampler the port does not have yet
    raise before any data is read, naming their ROADMAP.md item (20, 22
    or 23). The cases of options ported since (PORTED_TRAINING_OPTIONS)
    keep their ids and check instead that `cli.main` runs with them:
    one train step with a finite loss (and the cache's report line with
    --device_cache and --device_cache_shard, one process holding the
    one shard); with --debug 1 the step's renders (the JAX hooks'
    file names) and the final eval's; with --eval_oracle_hm a val epoch whose heatmap loss,
    the ground truth's own, is below the trained model's; with --test
    the val-only run: no step, the val split decoded and scored into
    results.json; with --trace a profiler trace of the epochs and one of
    the final eval in <debug_dir>/trace."""
    from codenet_torch.cli.main import main
    exp_id = "torch_unported_" + extra[0].strip("-")
    args = ["ctdet", "--dataset", "pascal", "--arch", "shufflenetv2",
            "--input_res", "64", "--gpus", "-1", "--exp_id", exp_id] + extra
    if extra not in PORTED_TRAINING_OPTIONS:
        with pytest.raises(NotImplementedError, match="item 2[023]"):
            main(args + ["--data_dir", "/nonexistent"])
        return
    save_dir = os.path.join(REPO, "exp", "ctdet", exp_id)
    if os.path.isdir(save_dir):
        import shutil
        shutil.rmtree(save_dir)
    from codenet_torch.utils.debugger import Debugger
    saves = []
    save_all_imgs = Debugger.save_all_imgs

    def counted(self, path, prefix="", **kw):
        saves.append(prefix)
        return save_all_imgs(self, path, prefix=prefix, **kw)
    monkeypatch.setattr(Debugger, "save_all_imgs", counted)
    vals = ["--val_intervals", "1" if extra == ["--eval_oracle_hm"]
            else "-1"]
    main(args + ["--data_dir", voc_root, "--batch_size", "2",
                 "--num_epochs", "1", "--num_iters", "1", *vals,
                 "--num_workers", "1", "--print_iter", "1"])
    out = capsys.readouterr().out
    losses = [float(line.split(" loss ")[1].split()[0])
              for line in out.splitlines() if line.startswith("train epoch")]
    assert "Mean AP" in out
    if extra == ["--test"]:
        assert losses == []
        with open(os.path.join(save_dir, "results.json")) as f:
            import json
            results = json.load(f)
        assert len(results) == 21 and len(results[1]) == 6
        assert not os.path.exists(os.path.join(save_dir, "model_last.pth"))
        return
    assert len(losses) == 1 and np.isfinite(losses[0])
    assert ("device_cache: 6 images" in out) == (
        extra in (["--device_cache"], ["--device_cache_shard"]))
    assert ("(sharded over 1 ranks)" in out) == (
        extra == ["--device_cache_shard"])
    if extra == ["--debug", "1"]:
        # the step's four renders, and the final eval's detector one per
        # val image (counted as saves: its file names carry the
        # millisecond, which two requests may share)
        names = sorted(os.listdir(os.path.join(save_dir, "debug")))
        assert [n for n in names if n.startswith("train_")] == [
            "train_0_gt_hm.png", "train_0_out_gt.png",
            "train_0_out_pred.png", "train_0_pred_hm.png"]
        assert sum(p.startswith("det_") for p in saves) == 6
        assert any(n.startswith("det_") for n in names)
    if extra == ["--eval_oracle_hm"]:
        scalars = _scalars(exp_id)
        assert scalars["val_hm_loss"] < 0.5 * scalars["train_hm_loss"]
    if extra == ["--trace"]:
        traces = os.listdir(os.path.join(save_dir, "debug", "trace"))
        assert len(traces) == 2 and all(
            n.endswith(".pt.trace.json") for n in traces), traces
