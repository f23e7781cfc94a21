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
  trained without it) ran unclamped.
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
