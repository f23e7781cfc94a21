"""Three repaired divergences of the port from the JAX package.

- F1: `cli.test` and `BaseDetector` raised on --trace while it was not
  ported, instead of running as if the flag were not set; now `cli.test
  --trace` writes a profiler trace of its eval loop into
  <debug_dir>/trace, as the JAX package does; since --debug's renders
  are ported, --debug >= 1 draws each request's detections into
  opt.debug_dir, as the JAX detector does;
- F2: `cli.main` runs ctdet's final eval whenever num_epochs > 0, as the
  JAX package does, also after a --resume from a checkpoint already at
  the last epoch (no epoch left to train);
- F3: every (dataset, task) pair the port refused is composed and
  sampled by the JAX package: where JAX yields a sample, the port
  composes the pair too and its sample equals JAX's (the JAX sampler's
  cv2 warp replaced by the port's, as the other sampler tests do); where
  JAX fails, the port refuses, and the test records JAX's error;
- F4: with --resume-quantize, a port .pth's recorded QAT recipe fills in
  only the quantization flags the command line does not give: a flag
  given there wins, also one equal to its default, as in the JAX package, which records no recipe and
  runs what its flags say. Before, the recipe overrode it, so the
  synthetic regression's `qat_clamped` eval (--act_clamp on a checkpoint
  trained without it) ran unclamped;
- F5: `--load_model` of a pytorchcv ImageNet ShuffleNetV2 (.pth with
  `features.*` keys) loads its backbone (layer0-layer4, renamed to the
  reference layout) and leaves the neck and heads at their init, as the
  JAX package's loader does; before, no key matched and training started
  from random weights. A reference ResNet checkpoint with a top-level
  key that is neither backbone nor head-shaped raises in both packages.
"""

import json
import os
import types

import numpy as np
import pytest

from codenet_tpu import config as jcfg
from codenet_tpu.data import samplers as JS
from codenet_tpu.data.datasets import get_dataset as jax_get_dataset
from codenet_torch import config as tcfg
from codenet_torch.data.affine import invert_affine, warp_affine_u8
from codenet_torch.data.datasets import get_dataset
from codenet_torch.engine import detector as TDET

cv2 = pytest.importorskip("cv2")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def data_root(tmp_path_factory):
    """A synthetic VOC set, a KITTI set, and a COCO set with instances,
    person keypoints and extreme points (instances_extreme_*.json)."""
    from synthetic import make_voc_dataset
    from synthetic_kitti import make_kitti_dataset
    root = str(tmp_path_factory.mktemp("torch_faults"))
    make_voc_dataset(root, num_images=3, img_w=160, img_h=120)
    make_kitti_dataset(root, num_images=3, img_w=256, img_h=96)
    base = os.path.join(root, "coco")
    os.makedirs(os.path.join(base, "annotations"))
    r = np.random.RandomState(80)
    for split in ("train", "val"):
        os.makedirs(os.path.join(base, split + "2017"))
        images, anns, kanns, eanns = [], [], [], []
        for i in range(2):
            w, h = 160, 120
            img = (r.rand(h, w, 3) * 80).astype(np.uint8)
            name = "{:012d}.png".format(i + 1)
            images.append({"id": i + 1, "file_name": name, "width": w,
                           "height": h})
            for _ in range(2):
                bw, bh = r.randint(16, 60), r.randint(16, 50)
                x, y = r.randint(0, w - bw), r.randint(0, h - bh)
                img[y:y + bh, x:x + bw] = r.randint(100, 256, 3)
                ann = {"id": len(anns) + 1, "image_id": i + 1,
                       "category_id": 1, "bbox": [float(x), float(y),
                                                  float(bw), float(bh)],
                       "area": float(bw * bh), "iscrowd": 0}
                anns.append(ann)
                kps = np.stack([x + r.rand(17) * bw, y + r.rand(17) * bh,
                                np.full(17, 2)], axis=1)
                kanns.append(dict(ann, keypoints=kps.reshape(-1).tolist(),
                                  num_keypoints=17))
                u = r.rand(4)
                eanns.append(dict(ann, extreme_points=[
                    x + u[0] * bw, y, x, y + u[1] * bh, x + u[2] * bw,
                    y + bh, x + bw, y + u[3] * bh]))
            cv2.imwrite(os.path.join(base, split + "2017", name), img)
        for prefix, a in (("instances", anns), ("person_keypoints", kanns),
                          ("instances_extreme", eanns)):
            with open(os.path.join(base, "annotations", "{}_{}2017.json"
                                   .format(prefix, split)), "w") as f:
                json.dump({"images": images, "annotations": a,
                           "categories": [{"id": 1, "name": "person"}]}, f)
    return root


def _voc_args(root, *extra):
    return ["ctdet", "--dataset", "pascal", "--arch", "shufflenetv2",
            "--input_res", "64", "--batch_size", "2", "--num_workers", "1",
            "--gpus", "-1", "--data_dir", root] + list(extra)


# -- F1 -----------------------------------------------------------------------

@pytest.mark.parametrize("flag", [["--debug", "1"], ["--trace"]],
                         ids=["debug", "trace"])
def test_cli_test_and_detector_refuse_unported_flags(data_root, flag,
                                                     monkeypatch):
    """--trace: cli.test writes one profiler trace of its eval loop into
    <debug_dir>/trace, a JSON trace that names the model's convolutions;
    --debug 1 runs both and renders one det_<ms>_out.png a request (the
    renders are counted as saves: two requests in one millisecond write
    one file name)."""
    import shutil
    from codenet_torch.cli.test import main as test_main
    opt = tcfg.update_dataset_info_and_set_heads(
        tcfg.parse(_voc_args(data_root, "--exp_id", "torch_faults_f1",
                             *flag)),
        tcfg.DATASET_SPECS["pascal"])
    if flag == ["--trace"]:
        trace_dir = os.path.join(opt.debug_dir, "trace")
        shutil.rmtree(trace_dir, ignore_errors=True)
        test_main(_voc_args(data_root, "--exp_id", "torch_faults_f1",
                            *flag))
        (name,) = os.listdir(trace_dir)
        assert name.endswith(".pt.trace.json")
        with open(os.path.join(trace_dir, name)) as f:
            events = json.load(f)["traceEvents"]
        assert any(e.get("name") == "aten::convolution" for e in events)
        TDET.CtdetDetector(opt, device="cpu")
        return
    from codenet_torch.utils.debugger import Debugger
    saves = []
    save_all_imgs = Debugger.save_all_imgs

    def counted(self, path, prefix="", **kw):
        saves.append((path, prefix, list(self.imgs)))
        return save_all_imgs(self, path, prefix=prefix, **kw)
    monkeypatch.setattr(Debugger, "save_all_imgs", counted)
    shutil.rmtree(opt.debug_dir, ignore_errors=True)
    test_main(_voc_args(data_root, "--exp_id", "torch_faults_f1", *flag))
    assert len(saves) == 3 and all(
        path == opt.debug_dir and prefix.startswith("det_") and
        imgs == ["out"] for path, prefix, imgs in saves)
    names = os.listdir(opt.debug_dir)
    assert names and all(
        n.startswith("det_") and n.endswith("_out.png") for n in names)
    from codenet_torch.data.image_io import read_png
    frame = (np.random.RandomState(3).rand(90, 120, 3) * 255).astype(
        np.uint8)
    shutil.rmtree(opt.debug_dir)
    TDET.CtdetDetector(opt, device="cpu").run(frame)
    (name,) = os.listdir(opt.debug_dir)
    assert read_png(os.path.join(opt.debug_dir, name)).shape == frame.shape


# -- F2 -----------------------------------------------------------------------

def test_final_eval_runs_after_resume_at_last_epoch(data_root, capsys):
    from codenet_torch.cli.main import main
    common = _voc_args(data_root, "--num_epochs", "1", "--num_iters", "1",
                       "--val_intervals", "-1", "--exp_id",
                       "torch_faults_f2")
    main(common)
    ckpt = os.path.join(REPO, "exp", "ctdet", "torch_faults_f2",
                        "model_last.pth")
    assert "Running final eval" in capsys.readouterr().out
    main(common + ["--resume", "--load_model", ckpt])
    out = capsys.readouterr().out
    assert "train epoch" not in out
    assert "Running final eval" in out and "Mean AP" in out


# -- F3 -----------------------------------------------------------------------

SERVED = {("pascal", "ctdet"), ("coco", "ctdet"), ("kitti", "ddd"),
          ("coco_hp", "multi_pose"), ("coco", "exdet")}
REFUSED_BEFORE = [(d, t) for t in ("ctdet", "ddd", "multi_pose", "exdet")
                  for d in ("pascal", "coco", "kitti", "coco_hp")
                  if (d, t) not in SERVED]
# what the JAX package's composition does with each (the samplers read
# fields only their own dataset's annotations carry)
JAX_FAILS = {"ddd": KeyError, "multi_pose": AttributeError,
             "exdet": KeyError}


def _opt(cfg, root, dataset, task):
    size = ["--input_h", "64", "--input_w", "128"] if dataset == "kitti" \
        else ["--input_res", "64"]
    args = [task, "--dataset", dataset, "--arch", "shufflenetv2",
            "--data_dir", root, "--gpus", "-1"] + size
    return cfg.update_dataset_info_and_set_heads(
        cfg.parse(args), cfg.DATASET_SPECS[dataset])


def _port_warp_in_jax_sampler(monkeypatch):
    real = JS.cv2

    def warp(img, trans, size, flags=None):
        return warp_affine_u8(img, invert_affine(trans), size[1], size[0])

    monkeypatch.setattr(JS, "cv2", types.SimpleNamespace(
        imread=real.imread, warpAffine=warp, INTER_LINEAR=real.INTER_LINEAR))


@pytest.mark.parametrize("dataset,task", REFUSED_BEFORE,
                         ids=["{}-{}".format(t, d) for d, t in REFUSED_BEFORE])
def test_pairs_follow_the_jax_composition(data_root, monkeypatch, dataset,
                                          task):
    _port_warp_in_jax_sampler(monkeypatch)
    try:
        jds = jax_get_dataset(dataset, task)(
            _opt(jcfg, data_root, dataset, task), "train")
        ref = jds.get_sample(0, rng=np.random.RandomState(5))
    except (KeyError, AttributeError) as e:
        assert isinstance(e, JAX_FAILS[task]), e
        with pytest.raises(NotImplementedError,
                           match="not {} on {}".format(task, dataset)):
            get_dataset(dataset, task)
        return
    assert task == "ctdet"
    tds = get_dataset(dataset, task)(_opt(tcfg, data_root, dataset, task),
                                     "train")
    got = tds.get_sample(0, rng=np.random.RandomState(5))
    assert set(got) == set(ref)
    assert int(got["reg_mask"].sum()) >= 1
    for k in ref:
        if k == "meta":
            for mk in ("c", "s", "gt_det", "img_id"):
                np.testing.assert_array_equal(got[k][mk], ref[k][mk])
            continue
        assert np.asarray(got[k]).dtype == np.asarray(ref[k]).dtype, k
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)


@pytest.mark.parametrize("trained_clamped", [False, True])
@pytest.mark.parametrize("flags", [[], ["--wt-percentile"],
                                   ["--wt-percentile", "--act_clamp"],
                                   ["--w-bit", "8"]],
                         ids=["defaults", "wt", "wt-clamp", "w8"])
def test_explicit_quant_flags_win_over_the_recipe(tmp_path, flags,
                                                  trained_clamped):
    """F4: the detector's quantization of a QAT .pth recorded with
    wt_percentile (and act_clamp or not): every flag given on the command
    line as the JAX detector reads it from the same flags, every flag left
    at its default as the recipe says."""
    from codenet_torch.engine import checkpoint
    from codenet_torch.models import create_model
    from codenet_torch.models.layers import QuantSpec
    recipe = QuantSpec(wt_percentile=True, act_clamp=trained_clamped)
    path = str(tmp_path / "model_last.pth")
    checkpoint.save_model(path, 1, create_model(
        "shufflenetv2", {"hm": 20, "wh": 2, "reg": 2}, 64, qspec=recipe,
        device="cpu"), qspec=recipe)
    args = ["ctdet", "--dataset", "pascal", "--arch", "shufflenetv2",
            "--input_res", "64", "--gpus", "-1", "--resume-quantize",
            "--load_model", path] + flags
    opt = tcfg.update_dataset_info_and_set_heads(
        tcfg.parse(args), tcfg.DATASET_SPECS["pascal"])
    got = TDET.CtdetDetector(opt, device="cpu").qspec
    jopt = jcfg.parse(args)
    defaults = tcfg.build_parser()
    for key in ("w_bit", "a_bit", "wt_percentile", "act_percentile",
                "act_clamp"):
        given = getattr(jopt, key)
        want = getattr(recipe, key) if given == defaults.get_default(key) \
            else given
        assert getattr(got, key) == want, key
    if "--act_clamp" in flags:
        assert got.act_clamp  # the regression's qat_clamped eval


@pytest.mark.parametrize("flags,w_bit", [([], 8), (["--w-bit", "4"], 4)],
                         ids=["recipe", "given-default"])
def test_given_flag_equal_to_its_default_wins_over_the_recipe(
        tmp_path, flags, w_bit):
    """F4: a flag given on the command line at its default value (--w-bit
    4 on an 8-bit recipe) is kept, as the JAX detector keeps it; left out,
    the recipe's value is taken. The given flags are what config.parse
    records, so export_w4a8.py reads a checkpoint as the detector does."""
    from codenet_torch.engine import checkpoint
    from codenet_torch.models import create_model
    from codenet_torch.models.layers import QuantSpec
    recipe = QuantSpec(w_bit=8, wt_percentile=True)
    path = str(tmp_path / "model_last.pth")
    checkpoint.save_model(path, 1, create_model(
        "shufflenetv2", {"hm": 20, "wh": 2, "reg": 2}, 64, qspec=recipe,
        device="cpu"), qspec=recipe)
    args = ["ctdet", "--dataset", "pascal", "--arch", "shufflenetv2",
            "--input_res", "64", "--gpus", "-1", "--resume-quantize",
            "--load_model", path] + flags
    opt = tcfg.update_dataset_info_and_set_heads(
        tcfg.parse(args), tcfg.DATASET_SPECS["pascal"])
    assert ("w_bit" in opt.given_flags) == bool(flags)
    got = TDET.CtdetDetector(opt, device="cpu").qspec
    assert got.w_bit == w_bit and got.wt_percentile
    if flags:
        assert jcfg.parse(args).w_bit == w_bit


# pytorchcv ShuffleNetV2 module names by reference layout name (the
# inverse of the JAX package's PYTORCHCV_RENAMES)
_PYTORCHCV = {"b2.0": "compress_conv1", "b2.1": "compress_bn1",
              "b2.3": "dw_conv2", "b2.4": "dw_bn2", "b2.5": "expand_conv3",
              "b2.6": "expand_bn3", "b1.0": "dw_conv4", "b1.1": "dw_bn4",
              "b1.2": "expand_conv5", "b1.3": "expand_bn5"}
_PYTORCHCV_ENDS = {"layer0.0": "features.init_block.conv.conv",
                   "layer0.1": "features.init_block.conv.bn",
                   "layer4.0": "features.final_block.conv",
                   "layer4.1": "features.final_block.bn"}


def _pytorchcv_name(key):
    """A reference backbone key under its pytorchcv name."""
    parts = key.split(".")
    head = ".".join(parts[:2])
    if head in _PYTORCHCV_ENDS:
        return ".".join([_PYTORCHCV_ENDS[head]] + parts[2:])
    stage, unit, branch, idx = parts[:4]
    return ".".join(["features", "stage" + stage[-1],
                     "unit{}".format(int(unit) + 1),
                     _PYTORCHCV[branch + "." + idx]] + parts[4:])


def _pytorchcv_checkpoint(model, path):
    """A seeded pytorchcv-named ImageNet checkpoint of `model`'s backbone
    (with its classifier and BN batch counters); returns it by reference
    name."""
    r = np.random.RandomState(55)
    import torch
    sd, by_ref = {}, {}
    for key, value in model.state_dict().items():
        if not key.startswith(("layer0.", "layer1.", "layer2.", "layer3.",
                               "layer4.")):
            continue
        if key.endswith("num_batches_tracked"):
            sd[_pytorchcv_name(key)] = torch.tensor(7)
            continue
        v = torch.from_numpy(r.rand(*value.shape).astype(np.float32)
                             + (0.5 if key.endswith("running_var")
                                else -0.5))
        sd[_pytorchcv_name(key)] = by_ref[key] = v
    sd["output.weight"] = torch.zeros(1000, 1024)
    sd["output.bias"] = torch.zeros(1000)
    torch.save(sd, path)
    return by_ref


@pytest.mark.parametrize("w2", [False, True], ids=["w1", "w2"])
def test_pytorchcv_backbone_warm_start_matches_jax(tmp_path, w2):
    """F5: the port's load_model and the JAX package's, from the same
    init (the port's, carried to JAX by engine/jax_weights.py), read a
    pytorchcv checkpoint into equal weights: every backbone weight and BN
    statistic the checkpoint's, everything else its init."""
    import jax
    from codenet_tpu.engine import checkpoint as jckpt
    from codenet_torch.engine import checkpoint
    from codenet_torch.engine.jax_weights import (from_jax_variables,
                                                  to_jax_variables)
    from codenet_torch.models import create_model
    import torch
    model = create_model("shufflenetv2", {"hm": 20, "wh": 2, "reg": 2}, 64,
                         w2=w2, device="cpu",
                         generator=torch.Generator().manual_seed(3))
    init = {k: v.clone() for k, v in model.state_dict().items()}
    path = str(tmp_path / "shufflenetv2_w{}.pth".format(2 if w2 else 1))
    backbone = _pytorchcv_checkpoint(model, path)
    checkpoint.load_model(path, model)
    got = model.state_dict()
    jvars, _, _ = jckpt.load_model(path, to_jax_variables(init))
    want = from_jax_variables(jax.tree_util.tree_map(np.asarray, jvars))
    assert len(backbone) == 280  # 56 convs and 56 BNs
    for key, value in got.items():
        if key.endswith("num_batches_tracked"):
            assert torch.equal(value, init[key]), key
            continue
        np.testing.assert_array_equal(value.numpy(), want[key].numpy(),
                                      err_msg=key)
        expect = backbone.get(key, init[key])
        np.testing.assert_array_equal(value.numpy(), expect.numpy(),
                                      err_msg=key)


def test_stray_top_level_keys_raise_as_in_jax(tmp_path):
    """F5: a reference res_18 checkpoint with a classifier left in it
    raises in both loaders, naming the stray key."""
    import jax
    from codenet_tpu.engine import checkpoint as jckpt
    from codenet_torch.engine import checkpoint
    from codenet_torch.engine.jax_weights import to_jax_variables
    from codenet_torch.models import create_model
    import torch
    model = create_model("res_18", {"hm": 20, "wh": 2, "reg": 2}, 64,
                         device="cpu")
    sd = dict(model.state_dict(), **{"fc.linear.weight": torch.zeros(3, 512)})
    path = str(tmp_path / "res18_fc.pth")
    torch.save({"epoch": 1, "state_dict": sd}, path)
    with pytest.raises(ValueError) as jerr:
        jckpt.load_model(path, jax.tree_util.tree_map(
            np.asarray, to_jax_variables(model.state_dict())))
    with pytest.raises(ValueError) as terr:
        checkpoint.load_model(path, model)
    for err in (jerr, terr):
        assert "neither backbone" in str(err.value)
        assert "['fc']" in str(err.value)


@pytest.mark.parametrize("arch", ["res_18", "dlav0_34", "dla_34",
                                  "hourglass"])
def test_every_backbones_checkpoint_passes_the_key_check(tmp_path, arch):
    """F5's key check passes each backbone's own .pth (the hourglass's
    heads are one conv stack per stack of the network: 'hm.0.0.conv.
    weight'), which loads back equal."""
    import torch
    from codenet_torch.engine import checkpoint
    from codenet_torch.models import create_model
    heads = {"hm": 20, "wh": 2, "reg": 2}
    res = 128 if arch == "hourglass" else 64
    model = create_model(arch, heads, res, device="cpu",
                         generator=torch.Generator().manual_seed(6))
    path = str(tmp_path / "model.pth")
    checkpoint.save_model(path, 2, model)
    other = create_model(arch, heads, res, device="cpu",
                         generator=torch.Generator().manual_seed(7))
    _, epoch = checkpoint.load_model(path, other, strict=True)
    assert epoch == 2
    for k, v in model.state_dict().items():
        assert torch.equal(other.state_dict()[k], v), k
