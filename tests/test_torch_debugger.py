"""The port's visual and val-side entry points against the JAX package.

- utils/debugger.py: every drawing call of the port's Debugger gives the
  JAX Debugger's pixels on the same inputs (numpy's generator seeded
  alike: the class colours are its draws), in both themes, and its PNG
  files read back as the JAX package's cv2 files do;
- utils/oracle.py: the oracle map equal to the JAX package's;
- the oracle val step: the wh and offset probes give those losses 0;
- Trainer.val with --test: the decoded val results held against the JAX
  trainer's on the same weights (rows of score > 0.1: under it, tied
  low scores order per framework, ROADMAP's "Ties");
- --debug in cli.main for ctdet, multi_pose, ddd and exdet: each task's
  renders under the JAX hooks' file names;
- cli.demo and tools_torch/vis_pred.py write their renders.
"""

import importlib.util
import json
import os

import numpy as np
import pytest

cv2 = pytest.importorskip("cv2")

from test_torch_common import perturb_variables, rng
from test_torch_faults import _voc_args, data_root  # noqa: F401

from codenet_tpu.utils import debugger as JD
from codenet_tpu.utils import oracle as JO
from codenet_torch import config as tcfg
from codenet_torch.data.image_io import read_png, write_png
from codenet_torch.utils import debugger as TD
from codenet_torch.utils import oracle as TO

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# -- Debugger -------------------------------------------------------------------

def _pair(theme, **kw):
    """The JAX and the port Debugger, each made after seeding numpy's
    generator alike."""
    out = []
    for mod in (JD, TD):
        np.random.seed(11)
        out.append(mod.Debugger(theme=theme, **kw))
    return out


def _ddd_dets(r):
    """{class: (n, 15) rows} [alpha box(4) dim(3) loc(3) rot_y ... score]
    in front of a KITTI camera."""
    dets = {}
    for cls in (1, 2, 3):
        rows = np.zeros((3, 15), np.float32)
        rows[:, 5:8] = r.uniform(1.0, 4.0, (3, 3))
        rows[:, 8] = r.uniform(-6, 6, 3)
        rows[:, 9] = 1.6
        rows[:, 10] = r.uniform(5, 30, 3)
        rows[:, 11] = r.uniform(-np.pi, np.pi, 3)
        rows[:, -1] = r.uniform(0.2, 0.9, 3)
        dets[cls] = rows
    return dets


CALIB = np.array([[707.05, 0, 604.08, 45.76], [0, 707.05, 180.51, -0.35],
                  [0, 0, 1.0, 0.005]], np.float32)


def _draw_all(dbg, r, img, hm, png):
    dbg.add_img(img, img_id="plain")
    dbg.add_img(img, img_id="reverted", revert_color=True)
    dbg.add_mask(r.rand(*img.shape[:2]), img, img_id="mask")
    dbg.add_blend_img(img, dbg.gen_colormap(hm), "blend")
    dbg.add_blend_img(img, dbg.gen_colormap(hm, (30, 50)), "blend_resized")
    dbg.add_img(img, img_id="boxes")
    for k in range(6):
        x1, y1 = r.uniform(-10, 150, 2)
        dbg.add_coco_bbox([x1, y1, x1 + r.uniform(5, 80),
                           y1 + r.uniform(5, 60)], k * 3 % 20,
                          r.rand(), show_txt=bool(k % 2), img_id="boxes")
    dbg.add_img(img, img_id="pose")
    dbg.add_coco_hp(r.uniform(-5, 150, 34), img_id="pose")
    dets = np.concatenate([r.uniform(0, 30, (8, 2)), r.rand(8, 1),
                           r.randint(0, 20, (8, 1))], 1).astype(np.float32)
    dbg.add_ct_detection(img, dets, center_thresh=0.3, img_id="ct")
    ddd = _ddd_dets(r)
    dbg.add_3d_detection(img, ddd, CALIB, center_thresh=0.3, img_id="3d")
    dbg.add_3d_detection(png, ddd, CALIB, center_thresh=0.3,
                         img_id="3d_file")
    return ddd


def _bird_view(colors, dets, center_thresh=0.3, world_size=64,
               out_size=384):
    """What the JAX Debugger's add_bird_view means to draw: its corners
    (JD._compute_bird_rect) in int pixels, one line between each pair.
    It raises instead (cv2 refuses the float corner its first line ends
    at), so the port is held to this."""
    view = np.ones((out_size, out_size, 3), np.uint8) * 230
    for cat in dets:
        cl = (255 - colors[cat - 1, 0, 0]).tolist()
        for row in dets[cat]:
            if row[-1] > center_thresh:
                rect = [(int(x), int(z)) for x, z in JD._compute_bird_rect(
                    row[5:8], row[8:11], row[11], world_size, out_size)]
                for k in range(4):
                    cv2.line(view, rect[k], rect[(k + 1) % 4], cl, 1,
                             lineType=cv2.LINE_AA)
    return view


@pytest.mark.parametrize("theme", ["white", "black"])
def test_debugger_pixels_equal_jax(theme, tmp_path):
    """Every drawing call, the same pixels (the bird view: what the JAX
    code means, see _bird_view); the saved PNGs read back as the JAX
    Debugger's cv2 files."""
    img = (rng(12).rand(120, 160, 3) * 255).astype(np.uint8)
    hm = rng(13).rand(30, 40, 20).astype(np.float32) ** 4
    png = str(tmp_path / "frame.png")
    write_png(png, img)
    jax_dbg, port_dbg = _pair(theme, dataset="pascal", down_ratio=4)
    np.testing.assert_array_equal(port_dbg.colors, jax_dbg.colors)
    assert port_dbg.names == jax_dbg.names
    for dbg in (jax_dbg, port_dbg):
        ddd = _draw_all(dbg, rng(14), img, hm, png)
    with pytest.raises(cv2.error):
        jax_dbg.add_bird_view(ddd, center_thresh=0.3, img_id="bird")
    port_dbg.add_bird_view(ddd, center_thresh=0.3, img_id="bird")
    jax_dbg.imgs["bird"] = _bird_view(jax_dbg.colors, ddd)
    assert (jax_dbg.imgs["bird"] != 230).any()
    assert list(port_dbg.imgs) == list(jax_dbg.imgs)
    for name, ref in jax_dbg.imgs.items():
        np.testing.assert_array_equal(port_dbg.imgs[name], ref,
                                      err_msg=name)
    jax_dbg.save_all_imgs(str(tmp_path / "jax"), prefix="p_")
    port_dbg.save_all_imgs(str(tmp_path / "port"), prefix="p_")
    assert sorted(os.listdir(tmp_path / "port")) == \
        sorted(os.listdir(tmp_path / "jax"))
    for name in os.listdir(tmp_path / "jax"):
        np.testing.assert_array_equal(
            read_png(str(tmp_path / "port" / name)),
            cv2.imread(str(tmp_path / "jax" / name)), err_msg=name)


@pytest.mark.parametrize("dataset", ["coco", "kitti", None])
def test_debugger_class_names_equal_jax(dataset):
    jax_dbg, port_dbg = _pair("white", dataset=dataset, num_classes=7)
    assert port_dbg.names == jax_dbg.names
    assert port_dbg.num_classes == jax_dbg.num_classes


# -- oracle -----------------------------------------------------------------------

def test_oracle_map_equal_jax():
    """Random features on random centres (some slots empty, one image
    with none): the same nearest-object fill."""
    r = rng(15)
    feat = r.randn(3, 6, 2).astype(np.float32)
    ind = r.randint(1, 12 * 10, (3, 6))
    ind[0, 4:] = 0
    ind[2] = 0
    ref = JO.gen_oracle_map(feat, ind, 12, 10)
    out = TO.gen_oracle_map(feat, ind, 12, 10)
    assert out.shape == (3, 10, 12, 2) and out.dtype == np.float32
    np.testing.assert_array_equal(out, ref)
    assert not out[2].any()


def test_oracle_val_step_zeroes_probed_losses(data_root):  # noqa: F811
    """--eval_oracle_wh --eval_oracle_offset: the val loss reads the
    ground truth's own wh and offset at every object, so both are 0."""
    from codenet_torch.data.datasets import get_dataset
    from codenet_torch.data.loader import DataLoader
    from codenet_torch.engine.trainer import Trainer
    opt = tcfg.update_dataset_info_and_set_heads(
        tcfg.parse(_voc_args(data_root, "--eval_oracle_wh",
                             "--eval_oracle_offset")),
        tcfg.DATASET_SPECS["pascal"])
    trainer = Trainer(opt, device="cpu")
    loader = DataLoader(get_dataset("pascal", "ctdet")(opt, "val"), 1,
                        shuffle=False, num_workers=1)
    stats, results = trainer.val(0, loader)
    assert stats["wh_loss"] == 0 and stats["off_loss"] == 0
    assert stats["hm_loss"] > 0 and results == {}


# -- Trainer.val with --test --------------------------------------------------------

def test_val_results_match_jax_trainer(data_root):  # noqa: F811
    """The same weights in both trainers; --test's decoded results of the
    3 val images, class by class, rows of score > 0.1 within 1e-3 px and
    1e-4 of score."""
    from codenet_tpu import config as jcfg
    from codenet_tpu.data.datasets import get_dataset as jax_get_dataset
    from codenet_tpu.data.loader import DataLoader as JaxDataLoader
    from codenet_tpu.engine.torch_import import convert_shufflenetv2
    from codenet_tpu.engine.trainer import Trainer as JaxTrainer
    from codenet_torch.data.datasets import get_dataset
    from codenet_torch.data.loader import DataLoader
    from codenet_torch.engine.jax_weights import from_jax_variables
    from codenet_torch.engine.trainer import Trainer

    args = _voc_args(data_root, "--test", "--K", "20")
    topt = tcfg.update_dataset_info_and_set_heads(
        tcfg.parse(args), tcfg.DATASET_SPECS["pascal"])
    jopt = jcfg.update_dataset_info_and_set_heads(
        jcfg.parse(args), jcfg.DATASET_SPECS["pascal"])
    trainer = Trainer(topt, device="cpu")
    sd = {k: v.numpy() for k, v in trainer.model.state_dict().items()}
    variables = perturb_variables(convert_shufflenetv2(sd), seed=16)
    trainer.model.load_state_dict(from_jax_variables(variables))
    jtrainer = JaxTrainer(jopt)
    jtrainer.variables = variables

    _, port = trainer.val(0, DataLoader(get_dataset("pascal", "ctdet")(
        topt, "val"), 1, shuffle=False, num_workers=1))
    _, ref = jtrainer.val(0, JaxDataLoader(jax_get_dataset(
        "pascal", "ctdet")(jopt, "val"), 1, shuffle=False, num_workers=1))
    assert sorted(port) == sorted(ref) and len(port) == 3
    kept = 0
    for img_id, classes in ref.items():
        assert sorted(port[img_id]) == sorted(classes)
        for cls, rows in classes.items():
            a = np.asarray(rows, np.float32).reshape(-1, 5)
            b = np.asarray(port[img_id][cls], np.float32).reshape(-1, 5)
            a, b = a[a[:, 4] > 0.1], b[b[:, 4] > 0.1]
            kept += len(a)
            a, b = a[np.lexsort(a.T)], b[np.lexsort(b.T)]
            np.testing.assert_allclose(b[:, :4], a[:, :4], atol=1e-3)
            np.testing.assert_allclose(b[:, 4], a[:, 4], atol=1e-4)
    assert kept > 0


# -- --debug in cli.main, per task ------------------------------------------------------

TASK_RENDERS = {
    "ctdet": ["gt_hm", "out_gt", "out_pred", "pred_hm"],
    "multi_pose": ["gt_hm", "gt_hmhp", "out_pred", "pred_hm", "pred_hmhp"],
    "ddd": ["add_pred", "bird_pred", "det_pred", "hm_gt", "hm_pred"],
    "exdet": ["gt", "gt_c", "out", "pred", "pred_c"],
}


@pytest.mark.parametrize("task", list(TASK_RENDERS))
def test_debug_renders_each_task(task, data_root, capsys):  # noqa: F811
    """cli.main --debug 1: one step, then the first image's renders under
    the JAX hooks' names (train_0_<name>.png), each an image."""
    import shutil
    from codenet_torch.cli.main import main
    dataset, size = {"ctdet": ("pascal", ["--input_res", "64"]),
                     "multi_pose": ("coco_hp", ["--input_res", "64"]),
                     "ddd": ("kitti", ["--input_h", "96", "--input_w",
                                       "256"]),
                     "exdet": ("coco", ["--input_res", "64", "--K",
                                        "6"])}[task]
    exp_id = "torch_debug_" + task
    debug_dir = os.path.join(REPO, "exp", task, exp_id, "debug")
    shutil.rmtree(debug_dir, ignore_errors=True)
    main([task, "--dataset", dataset, "--arch", "shufflenetv2", *size,
          "--gpus", "-1", "--data_dir", data_root, "--exp_id", exp_id,
          "--debug", "1", "--num_epochs", "1", "--num_iters", "1",
          "--val_intervals", "-1", "--num_workers", "1",
          "--print_iter", "1"])
    names = sorted(n for n in os.listdir(debug_dir)
                   if n.startswith("train_0_"))
    assert names == ["train_0_{}.png".format(n)
                     for n in TASK_RENDERS[task]]
    for n in names:
        assert read_png(os.path.join(debug_dir, n)).ndim == 3


# -- cli.demo and vis_pred ----------------------------------------------------------

def test_demo_and_vis_pred_write_renders(data_root, tmp_path):  # noqa: F811
    """cli.demo over the VOC images (one PNG each, named after the frame,
    at its size);
    vis_pred over a results.json of cli.test (a _pred and a _gt PNG per
    image)."""
    from codenet_torch.cli import demo
    from codenet_torch.cli.test import main as test_main
    img_dir = os.path.join(data_root, "voc", "images")
    assert demo.main(_voc_args(data_root, "--demo", img_dir, "--exp_id",
                               "torch_demo", "--vis_thresh", "0.0")) == 0
    out_dir = os.path.join(REPO, "exp", "ctdet", "torch_demo", "demo")
    from codenet_torch.engine.detector import imread
    frames = sorted(os.listdir(img_dir))
    assert sorted(os.listdir(out_dir)) == [
        os.path.splitext(f)[0] + ".png" for f in frames]
    for name in frames:
        assert read_png(os.path.join(
            out_dir, os.path.splitext(name)[0] + ".png")).shape == \
            imread(os.path.join(img_dir, name)).shape
    assert demo.main(_voc_args(data_root, "--exp_id", "torch_demo")) == 2

    test_main(_voc_args(data_root, "--exp_id", "torch_vis"))
    spec = importlib.util.spec_from_file_location(
        "port_vis_pred", os.path.join(REPO, "tools_torch", "vis_pred.py"))
    vis = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(vis)
    gt = os.path.join(data_root, "voc", "annotations",
                      "pascal_test2007.json")
    vis.main([os.path.join(REPO, "exp", "ctdet", "torch_vis",
                           "results.json"), "--gt", gt, "--img_dir",
              img_dir, "--out_dir", str(tmp_path / "vis"), "--thresh",
              "0.0"])
    with open(gt) as f:
        stems = [os.path.splitext(i["file_name"])[0]
                 for i in json.load(f)["images"]]
    assert sorted(os.listdir(tmp_path / "vis")) == sorted(
        "{}_{}.png".format(s, k) for s in stems for k in ("gt", "pred"))
