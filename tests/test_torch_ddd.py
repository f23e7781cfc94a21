"""ddd (KITTI 3D) in the port, against the JAX package.

On seeded numpy inputs and tests/synthetic_kitti.py's KITTI-format set,
each with its tolerance:

- `utils/ddd_utils.py`: exact; `ddd_post_process`: 1e-6;
- `ddd_decode` with and without wh and reg: exact;
- `bin_rot_loss` and `ddd_loss` (the masked-logit cross-entropy and the
  rot_mask-masked wh / reg kept): loss parts and gradients 1e-6;
- `DddSampler` against the JAX sampler (ignore regions, --rect_mask,
  the --aug_ddd draw): every target exact, the uint8 input within one
  level (the JAX sampler warps with cv2, the port with its own warp);
- the port's KITTI scorer (csrc/kitti_eval.cpp, its own copy) against
  the JAX package's on tests/test_kitti_eval.py's generated scenarios:
  equal APs and 41-point curves; `KITTI.save_results` writes the JAX
  package's bytes; a scorer that does not build raises;
- heads at 96x256 from the JAX model's weights (2e-3 of each head's
  max), the weights back exactly, and a JAX ddd `.ckpt` loaded;
- one FP32 train step from the conditioned init
  (test_torch_common.assert_train_step_matches_jax: 5e-3);
- `DddDetector.run` with a per-image calib against the JAX detector on
  the same pre-processed image: 2e-3, and the calib is the request's;
- `cli.main ddd` -> `cli.quant_main ddd` -> `cli.test ddd` (prefetched
  and --not_prefetch_test) ending in the KITTI AP table.

The JAX side runs on its XLA deform path (the Pallas kernels are held in
test_torch_deform.py).
"""

import json
import os
import types

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from test_torch_common import (assert_heads_close,
                               assert_train_step_matches_jax,
                               perturb_variables, raise_bn_biases, rng,
                               to_np)

from codenet_tpu import config as jcfg
from codenet_tpu.data.datasets import KITTI as JKITTI
from codenet_tpu.data.datasets import get_dataset as jax_get_dataset
from codenet_tpu.engine import detector as JDET
from codenet_tpu.engine.torch_import import convert_shufflenetv2
from codenet_tpu.engine.trainer import Trainer as JaxTrainer
from codenet_tpu.eval import kitti_eval as JKE
from codenet_tpu.models import create_model as jax_create_model
from codenet_tpu.models import decode as JDEC
from codenet_tpu.models import losses as JL
from codenet_tpu.models.fused_heads import eval_forward
from codenet_tpu.utils import ddd_utils as JU
from codenet_tpu.utils import post_process as JPP
from codenet_torch import config as tcfg
from codenet_torch.data.datasets import KITTI, get_dataset
from codenet_torch.data.loader import DataLoader
from codenet_torch.engine import detector as TDET
from codenet_torch.engine.jax_weights import (from_jax_variables,
                                              to_jax_variables)
from codenet_torch.engine.trainer import Trainer
from codenet_torch.eval import kitti_eval as TKE
from codenet_torch.models import create_model
from codenet_torch.models import decode as TDEC
from codenet_torch.models import losses as TL
from codenet_torch.utils import ddd_utils as TU
from codenet_torch.utils import post_process as TPP

cv2 = pytest.importorskip("cv2")

from synthetic_kitti import make_kitti_dataset  # noqa: E402
from test_kitti_eval import _gen_scenario  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DDD_HEADS = {"hm": 3, "dep": 1, "rot": 8, "dim": 3, "wh": 2, "reg": 2}
LR = 1.25e-4
CALIB = np.array([[300.0, 0, 150.0, 4.5], [0, 310.0, 55.0, -0.3],
                  [0, 0, 1.0, 0.005]], np.float32)


@pytest.fixture(scope="module")
def kitti_root(tmp_path_factory):
    """tests/synthetic_kitti.py's set (6 frames of 320x120, 3D boxes
    projected through a per-image P2), with ignore regions added to each
    split: a Van (ignore as Car), a DontCare (ignore every class) and a
    Tram (skipped) per frame."""
    root = str(tmp_path_factory.mktemp("torch_kitti"))
    make_kitti_dataset(root, num_images=6, img_w=320, img_h=120, seed=3)
    ann_dir = os.path.join(root, "kitti", "annotations")
    r = rng(80)
    for split in ("train", "val"):
        path = os.path.join(ann_dir, "kitti_3dop_{}.json".format(split))
        with open(path) as f:
            db = json.load(f)
        for img in db["images"]:
            for cat in (4, 9, 7):
                x, y = float(r.uniform(0, 250)), float(r.uniform(0, 80))
                bw, bh = float(r.uniform(12, 60)), float(r.uniform(10, 35))
                db["annotations"].append({
                    "id": len(db["annotations"]) + 100,
                    "image_id": img["id"], "category_id": cat,
                    "bbox": [x, y, bw, bh], "area": bw * bh, "iscrowd": 0,
                    "alpha": float(r.uniform(-3, 3)),
                    "depth": float(r.uniform(5, 30)),
                    "dim": [1.5, 1.6, 3.9]})
        with open(path, "w") as f:
            json.dump(db, f)
    return root


def _ddd_opt(cfg, root="", extra=()):
    args = ["ddd", "--dataset", "kitti", "--arch", "shufflenetv2",
            "--input_h", "96", "--input_w", "256", "--batch_size", "2",
            "--gpus", "-1", "--data_dir", root] + list(extra)
    return cfg.update_dataset_info_and_set_heads(
        cfg.parse(args), cfg.DATASET_SPECS["kitti"])


# -- 3D geometry, decode, post-process ---------------------------------------

def test_ddd_utils_match_jax():
    r = rng(81)
    for _ in range(5):
        dim = r.uniform(0.5, 4, 3).astype(np.float32)
        loc = r.uniform([-10, 0.5, 5], [10, 2.5, 40]).astype(np.float32)
        ry = float(r.uniform(-np.pi, np.pi))
        np.testing.assert_array_equal(TU.compute_box_3d(dim, loc, ry),
                                      JU.compute_box_3d(dim, loc, ry))
        np.testing.assert_array_equal(TU.project_3d_bbox(loc, dim, ry, CALIB),
                                      JU.project_3d_bbox(loc, dim, ry, CALIB))
        pts = r.uniform(-5, 5, (7, 3)).astype(np.float32) + [0, 0, 20]
        np.testing.assert_array_equal(TU.project_to_image(pts, CALIB),
                                      JU.project_to_image(pts, CALIB))
        pt, depth = r.uniform(0, 300, 2), float(r.uniform(5, 40))
        np.testing.assert_array_equal(
            TU.unproject_2d_to_3d(pt, depth, CALIB),
            JU.unproject_2d_to_3d(pt, depth, CALIB))
        alpha, x = float(r.uniform(-3.1, 3.1)), float(r.uniform(0, 300))
        for fn in ("alpha2rot_y", "rot_y2alpha"):
            assert getattr(TU, fn)(alpha, x, 150.0, 300.0) == \
                getattr(JU, fn)(alpha, x, 150.0, 300.0)
        a, b = TU.ddd2locrot(pt, alpha, dim, depth, CALIB), \
            JU.ddd2locrot(pt, alpha, dim, depth, CALIB)
        np.testing.assert_array_equal(a[0], b[0])
        assert a[1] == b[1]


def _ddd_heads(seed, n=2, h=24, w=64):
    r = rng(seed)
    return {"hm": r.rand(n, h, w, 3).astype(np.float32),
            "rot": r.randn(n, h, w, 8).astype(np.float32),
            "dep": r.uniform(1, 50, (n, h, w, 1)).astype(np.float32),
            "dim": r.uniform(0.5, 4, (n, h, w, 3)).astype(np.float32),
            "wh": r.uniform(2, 30, (n, h, w, 2)).astype(np.float32),
            "reg": r.rand(n, h, w, 2).astype(np.float32)}


@pytest.mark.parametrize("parts", ["all", "no_wh", "no_reg"])
def test_ddd_decode_matches_jax(parts):
    """(N, K, 18 or 16) rows of seeded heads, K below the maps' peak
    count: equal."""
    heads = _ddd_heads(82)
    wh = None if parts == "no_wh" else heads["wh"]
    reg = None if parts == "no_reg" else heads["reg"]

    def run(mod, conv):
        return mod.ddd_decode(conv(heads["hm"]), conv(heads["rot"]),
                              conv(heads["dep"]), conv(heads["dim"]),
                              wh=None if wh is None else conv(wh),
                              reg=None if reg is None else conv(reg), k=20)
    ref = np.asarray(run(JDEC, jnp.asarray))
    out = run(TDEC, torch.from_numpy).numpy()
    assert out.shape == ref.shape == (2, 20, 16 if parts == "no_wh" else 18)
    np.testing.assert_array_equal(out, ref)


def test_ddd_post_process_matches_jax():
    """Per class (n, 14) [alpha box dim location rotation_y score] from
    the decode's rows: 1e-6."""
    heads = _ddd_heads(83, n=1)
    dets = TDEC.ddd_decode(*(torch.from_numpy(heads[k]) for k in
                             ("hm", "rot", "dep", "dim")),
                           wh=torch.from_numpy(heads["wh"]),
                           reg=torch.from_numpy(heads["reg"]), k=30).numpy()
    opt = types.SimpleNamespace(output_w=64, output_h=24, num_classes=3)
    c, s = [np.array([160.0, 60.0], np.float32)], [np.array([320, 120])]
    ref = JPP.ddd_post_process(dets.copy(), c, s, [CALIB], opt)
    out = TPP.ddd_post_process(dets.copy(), c, s, [CALIB], opt)
    assert list(out[0]) == list(ref[0]) == [1, 2, 3]
    rows = 0
    for j in (1, 2, 3):
        assert out[0][j].shape == ref[0][j].shape
        np.testing.assert_allclose(out[0][j], ref[0][j], rtol=0, atol=1e-6)
        rows += len(out[0][j])
    assert rows == 30


# -- losses -----------------------------------------------------------------

def _rot_batch(seed, n=2, m=6, h=8, w=8):
    r = rng(seed)
    rotbin = (r.rand(n, m, 2) < 0.6).astype(np.int64)
    return {"ind": r.randint(0, h * w, (n, m)).astype(np.int64),
            "rot_mask": (np.arange(m) < 4).astype(np.uint8)[None]
            .repeat(n, 0),
            "reg_mask": (np.arange(m) < 3).astype(np.uint8)[None]
            .repeat(n, 0),
            "rotbin": rotbin,
            "rotres": r.uniform(-1, 1, (n, m, 2)).astype(np.float32),
            "dep": r.uniform(2, 40, (n, m, 1)).astype(np.float32),
            "dim": r.uniform(0.5, 4, (n, m, 3)).astype(np.float32),
            "wh": r.uniform(1, 9, (n, m, 2)).astype(np.float32),
            "reg": r.rand(n, m, 2).astype(np.float32),
            "hm": (r.rand(n, h, w, 3) * 0.9).astype(np.float32)}


def _value_and_grads(jfn, tfn, outs):
    (ref, rstats), rgrad = jax.value_and_grad(jfn, has_aux=True)(
        {k: jnp.asarray(v) for k, v in outs.items()})
    touts = {k: torch.from_numpy(v).requires_grad_() for k, v in outs.items()}
    loss, stats = tfn(touts)
    loss.backward()
    return (ref, rstats, rgrad), (loss, stats, touts)


def test_bin_rot_loss_matches_jax():
    """Masked logits, CE over all rows, residuals over the active bins:
    loss and gradient 1e-6."""
    batch = _rot_batch(84)
    out = rng(85).randn(2, 8, 8, 8).astype(np.float32)
    args = ("rot_mask", "ind", "rotbin", "rotres")

    def jfn(o):
        v = JL.bin_rot_loss(o["rot"], *(jnp.asarray(batch[a])
                                        for a in args))
        return v, {}

    def tfn(o):
        return TL.bin_rot_loss(o["rot"], *(torch.from_numpy(batch[a])
                                           for a in args)), {}
    (ref, _, rgrad), (loss, _, touts) = _value_and_grads(jfn, tfn,
                                                         {"rot": out})
    np.testing.assert_allclose(float(loss.detach()), float(ref), rtol=1e-6)
    np.testing.assert_allclose(to_np(touts["rot"].grad),
                               np.asarray(rgrad["rot"]), rtol=0, atol=1e-6)
    # the logits are masked, not the loss: masked rows still count in the
    # mean (a loss over the active rows alone would differ)
    assert float(loss.detach()) > 0


@pytest.mark.parametrize("case", ["all", "no_reg_bbox", "no_offset"])
def test_ddd_loss_matches_jax(case):
    """DddLoss: its seven parts and the gradients w.r.t. the six heads,
    1e-6 (wh and reg masked by rot_mask, the depth decoded as 1 /
    (sigmoid + 1e-6) - 1)."""
    opt = types.SimpleNamespace(
        hm_weight=1.0, dep_weight=1.0, dim_weight=1.0, rot_weight=1.0,
        wh_weight=0.1, off_weight=1.0, reg_bbox=case != "no_reg_bbox",
        reg_offset=case != "no_offset")
    batch = _rot_batch(86)
    r = rng(87)
    outs = {k: r.randn(2, 8, 8, c).astype(np.float32)
            for k, c in DDD_HEADS.items()}
    (ref, rstats, rgrad), (loss, stats, touts) = _value_and_grads(
        lambda o: JL.ddd_loss([o], {k: jnp.asarray(v)
                                    for k, v in batch.items()}, opt),
        lambda o: TL.ddd_loss([o], {k: torch.from_numpy(v)
                                    for k, v in batch.items()}, opt), outs)
    assert set(stats) == set(rstats)
    for k in rstats:
        np.testing.assert_allclose(float(torch.as_tensor(stats[k]).detach()),
                                   float(rstats[k]), rtol=1e-6, atol=1e-7,
                                   err_msg=k)
    for k in outs:
        g = touts[k].grad
        got = np.zeros_like(outs[k]) if g is None else to_np(g)
        np.testing.assert_allclose(got, np.asarray(rgrad[k]), rtol=0,
                                   atol=1e-6, err_msg=k)


# -- sampler ----------------------------------------------------------------

@pytest.mark.parametrize("extra", [[], ["--rect_mask"], ["--aug_ddd", "1"]],
                         ids=["default", "rect_mask", "always_aug"])
def test_sampler_matches_jax(kitti_root, extra):
    """Same RandomState, same sample, train and val: the --aug_ddd draw
    (reg_mask 0 on augmented samples), ignore regions, the 2-bin
    orientation targets and the per-image calib exact; the uint8 input
    within one level of the JAX sampler's cv2 warp."""
    objects = augmented = 0
    for split in ("train", "val"):
        jds = jax_get_dataset("kitti", "ddd")(_ddd_opt(jcfg, kitti_root,
                                                       extra), split)
        tds = get_dataset("kitti", "ddd")(_ddd_opt(tcfg, kitti_root, extra),
                                          split)
        for i in range(len(tds)):
            a = jds.get_sample(i, rng=np.random.RandomState(90 + i))
            b = tds.get_sample(i, rng=np.random.RandomState(90 + i))
            assert set(a) == set(b)
            for k in a:
                if k == "meta":
                    assert set(a[k]) == set(b[k])
                    for mk in ("c", "s", "gt_det", "calib", "img_id",
                               "image_path"):
                        np.testing.assert_array_equal(a[k][mk], b[k][mk],
                                                      err_msg=mk)
                    continue
                if k == "input_u8":
                    diff = np.abs(a[k].astype(int) - b[k].astype(int))
                    assert diff.max() <= 1, k
                    continue
                assert np.asarray(a[k]).dtype == np.asarray(b[k]).dtype, k
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)
            assert b["hm"].shape == (24, 64, 3)
            assert b["rotbin"].dtype == np.int64
            objects += int(b["rot_mask"].sum())
            augmented += int(b["rot_mask"].sum() - b["reg_mask"].sum())
            assert (b["hm"] == np.float32(0.9999)).any()  # ignore regions
    assert objects > 0
    if extra == ["--aug_ddd", "1"]:
        assert augmented > 0


# -- the KITTI scorer --------------------------------------------------------

@pytest.mark.parametrize("seed", range(6))
def test_kitti_scorer_matches_jax(tmp_path, seed):
    """tests/test_kitti_eval.py's generated scenarios (difficulty gates,
    neighbour classes, DontCare areas, false positives) scored by the
    port's own build of the scorer and by the JAX package's: equal
    records, APs and 41-point curves."""
    r = np.random.RandomState(100 + seed)
    gt_files, det_files = _gen_scenario(r, n_images=r.randint(6, 16))
    for name, files in (("gt", gt_files), ("det", det_files)):
        os.makedirs(tmp_path / name)
        for i, text in enumerate(files):
            (tmp_path / name / "{:06d}.txt".format(i)).write_text(text)
    gts, dets = [], []
    for i in range(len(gt_files)):
        for kind, out in (("gt", gts), ("det", dets)):
            path = str(tmp_path / kind / "{:06d}.txt".format(i))
            a = JKE.parse_label_file(path, kind == "gt")
            b = TKE.parse_label_file(path, kind == "gt")
            np.testing.assert_array_equal(a, b)
            out.append(b)
    ref = JKE.evaluate_records(gts, dets, return_curves=True)
    out = TKE.evaluate_records(gts, dets, return_curves=True)
    assert list(out) == list(ref)
    for key in ref:
        for metric in ("AP2D", "AOS", "AP_BEV", "AP_3D"):
            assert out[key][metric] == ref[key][metric], (key, metric)
        for curve, v in ref[key]["curves"].items():
            np.testing.assert_array_equal(out[key]["curves"][curve], v)
    assert sum(map(len, gts)) > 0 and sum(map(len, dets)) > 0
    assert TKE.CLASS_NAMES == JKE.CLASS_NAMES
    assert TKE.CLASSES == JKE.CLASSES


def test_kitti_scorer_build_failure_raises(tmp_path, monkeypatch):
    """A scorer source that does not compile raises; nothing else scores
    in its place."""
    bad = tmp_path / "kitti_eval.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(TKE, "SOURCE", bad)
    monkeypatch.setattr(TKE, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="kitti_eval.cpp failed"):
        TKE.build()


def test_kitti_save_results_matches_jax(tmp_path):
    """KITTI.save_results writes the JAX package's bytes, and the dataset
    metadata agree."""
    for attr in ("num_classes", "default_resolution", "max_objs",
                 "class_name", "cat_ids"):
        assert getattr(KITTI, attr) == getattr(JKITTI, attr), attr
    np.testing.assert_array_equal(KITTI.mean, JKITTI.mean)
    np.testing.assert_array_equal(KITTI.std, JKITTI.std)
    r = rng(88)
    results = {img_id: {j: r.randn(r.randint(0, 4), 14).astype(np.float32)
                        * 10 for j in (1, 2, 3)} for img_id in (3, 17)}
    for mod, name in ((JKITTI, "jax"), (KITTI, "port")):
        mod.save_results(types.SimpleNamespace(class_name=KITTI.class_name),
                         results, str(tmp_path / name))
    for img_id in results:
        fname = "{:06d}.txt".format(img_id)
        assert (tmp_path / "port" / "results" / fname).read_bytes() == \
            (tmp_path / "jax" / "results" / fname).read_bytes()


# -- weights, train step, detector -------------------------------------------

@pytest.fixture(scope="module")
def ddd_weights():
    model = create_model("shufflenetv2", DDD_HEADS, 64, device="cpu")
    sd = {k: v.numpy() for k, v in model.state_dict().items()}
    return perturb_variables(
        convert_shufflenetv2(sd, heads=tuple(sorted(DDD_HEADS))), seed=89)


def test_weights_carry_both_ways(ddd_weights):
    """The six ddd heads at 96x256: the port model from the JAX trees
    matches the JAX eval forward (2e-3 of each head's max), the `hm` bias
    at -2.19 and the others at 0 at init in both, and to_jax_variables
    gives the trees back exactly."""
    jmodel = jax_create_model("shufflenetv2", DDD_HEADS, 64)
    x = rng(91).randn(1, 96, 256, 3).astype(np.float32)
    ref = jax.jit(lambda v, x: eval_forward(jmodel, v, x))(
        ddd_weights, jnp.asarray(x))
    model = create_model("shufflenetv2", DDD_HEADS, 64, device="cpu")
    init = model.state_dict()
    jinit = jmodel.init(jax.random.PRNGKey(0),
                        jnp.zeros((1, 64, 64, 3)))["params"]
    for head in DDD_HEADS:
        want = -2.19 if head == "hm" else 0.0
        np.testing.assert_allclose(to_np(init[head + ".6.bias"]), want,
                                   rtol=1e-6)
        np.testing.assert_allclose(
            np.asarray(jinit["head_" + head]["out"]["bias"]), want,
            rtol=1e-6)
    model.load_state_dict(from_jax_variables(ddd_weights))
    with torch.no_grad():
        out = model(torch.from_numpy(x))
    assert_heads_close({k: np.asarray(v) for k, v in ref.items()},
                       {k: to_np(v) for k, v in out.items()}, rel=2e-3)
    back = to_jax_variables(model.state_dict())
    for coll in ("params", "batch_stats"):
        ref_leaves = dict(jax.tree_util.tree_flatten_with_path(
            ddd_weights[coll])[0])
        got_leaves = dict(jax.tree_util.tree_flatten_with_path(back[coll])[0])
        assert set(map(str, got_leaves)) == set(map(str, ref_leaves))
        for path, v in ref_leaves.items():
            np.testing.assert_array_equal(got_leaves[path],
                                          np.asarray(v, np.float32))


def test_load_jax_ddd_ckpt(tmp_path, ddd_weights):
    """A ddd .ckpt written by the JAX package's save_model loads into the
    port model, every tensor exact."""
    from codenet_tpu.engine.checkpoint import save_model
    from codenet_torch.engine import checkpoint
    path = str(tmp_path / "model_last.ckpt")
    save_model(path, 2, ddd_weights)
    model = create_model("shufflenetv2", DDD_HEADS, 64, device="cpu")
    _, epoch = checkpoint.load_model(path, model, strict=True)
    assert epoch == 2
    sd = model.state_dict()
    for k, v in from_jax_variables(ddd_weights).items():
        assert torch.equal(sd[k], v), k


def test_train_step_matches_jax(kitti_root):
    """One Adam step of the six-head model from the conditioned init on a
    sampler batch of the synthetic KITTI set (dense hm, rotbin int64,
    rot_mask and reg_mask apart)."""
    opt = _ddd_opt(tcfg, kitti_root, ["--aug_ddd", "0.5"])
    tds = get_dataset("kitti", "ddd")(opt, "train")
    batch = next(iter(DataLoader(tds, 2, shuffle=True, num_workers=1,
                                 seed=5)))
    assert int(batch["rot_mask"].sum()) >= 1
    trainer = Trainer(opt, device="cpu")
    trainer.init()
    raise_bn_biases(trainer.model, DDD_HEADS)
    jtr = JaxTrainer(_ddd_opt(jcfg, kitti_root))
    jtr.init()
    assert_train_step_matches_jax(trainer, jtr, batch, LR)


def test_detector_run_matches_jax(ddd_weights):
    """One request with its own calib through `run`, the port fed the JAX
    pre-processed image: per class (n, 14) rows within 2e-3; the same
    request under DEFAULT_CALIB gives other 3D locations, so the request's
    calib is the one used."""
    args = ["--K", "12", "--peak_thresh", "0.0"]
    jdet = JDET.DddDetector(_ddd_opt(jcfg, extra=args),
                            variables=ddd_weights)
    tdet = TDET.detector_factory("ddd")(
        _ddd_opt(tcfg, extra=args), state_dict=from_jax_variables(
            ddd_weights), device="cpu")
    assert isinstance(tdet, TDET.DddDetector)
    frame = rng(92).randint(0, 256, (120, 320, 3)).astype(np.uint8)
    images, meta = jdet.pre_process(frame, 1.0, {"calib": CALIB})
    own, _ = tdet.pre_process(frame, 1.0, {"calib": CALIB})
    assert np.abs(own.astype(int) - images.astype(int)).max() <= 1
    pre = {"image": frame, "images": {1.0: images}, "meta": {1.0: meta}}
    ref = jdet.run(pre)["results"]
    ret = tdet.run(pre)
    out = ret["results"]
    assert list(out) == list(ref) == [1, 2, 3]
    assert sum(len(v) for v in out.values()) == 12
    for j in ref:
        np.testing.assert_allclose(out[j], ref[j], rtol=2e-3, atol=2e-3)
    for key in ("tot", "pre", "net", "dec", "post", "merge"):
        assert ret[key] >= 0.0
    plain = dict(meta)
    plain["calib"] = tdet.DEFAULT_CALIB
    default = tdet.run({"image": frame, "images": {1.0: images},
                        "meta": {1.0: plain}})["results"]
    moved = max(float(np.abs(default[j][:, 8:11] - out[j][:, 8:11]).max())
                for j in out if len(out[j]))
    assert moved > 1.0


# -- the CLIs ---------------------------------------------------------------

def test_cli_ddd_trains_fine_tunes_and_scores(kitti_root, capsys):
    """cli.main ddd (2 iterations, no final eval, as in the JAX package),
    cli.quant_main ddd from its checkpoint, then cli.test ddd prefetched
    and --not_prefetch_test (the per-image calib threaded through both):
    equal KITTI AP tables (class x difficulty) and equal result txts of
    16 fields per row."""
    from codenet_torch.cli.main import main
    from codenet_torch.cli.quant_main import main as quant_main
    from codenet_torch.cli.test import main as test_main
    common = ["ddd", "--dataset", "kitti", "--arch", "shufflenetv2",
              "--input_h", "96", "--input_w", "256", "--gpus", "-1",
              "--num_workers", "1", "--data_dir", kitti_root]
    train = ["--batch_size", "2", "--num_epochs", "1", "--num_iters", "2",
             "--val_intervals", "-1", "--print_iter", "1"]
    main(common + train + ["--exp_id", "torch_ddd_cli"])
    out = capsys.readouterr().out
    losses = [float(ln.split(" loss ")[1].split()[0])
              for ln in out.splitlines() if ln.startswith("train epoch")]
    assert len(losses) == 2 and np.all(np.isfinite(losses))
    assert "rot_loss" in out and "Running final eval" not in out

    def ckpt(exp_id):
        return os.path.join(REPO, "exp", "ddd", exp_id, "model_last.pth")
    quant_main(common + train + ["--exp_id", "torch_ddd_qat", "--load_model",
                                 ckpt("torch_ddd_cli")])
    out = capsys.readouterr().out
    assert "No param" in out and "dep_loss" in out
    tables = []
    for exp_id, extra in (("torch_ddd_eval", []),
                          ("torch_ddd_eval_serial", ["--not_prefetch_test"])):
        stats = test_main(common + extra + [
            "--resume-quantize", "--load_model", ckpt("torch_ddd_qat"),
            "--peak_thresh", "0.0", "--exp_id", exp_id])
        out = capsys.readouterr().out
        assert set(stats) == {"{}_{}".format(c, d)
                              for c in ("Car", "Pedestrian", "Cyclist")
                              for d in ("easy", "moderate", "hard")}
        for v in stats.values():
            for metric in ("AP2D", "AOS", "AP_BEV", "AP_3D"):
                assert np.isfinite(v[metric]) and v[metric] >= -1.0
        assert "Car_moderate: AP2D" in out
        res = os.path.join(REPO, "exp", "ddd", exp_id, "results")
        txts = sorted(os.listdir(res))
        assert len(txts) == 6
        texts = [open(os.path.join(res, t)).read() for t in txts]
        rows = [ln.split() for t in texts for ln in t.splitlines()]
        assert rows and all(len(row) == 16 for row in rows)
        tables.append((stats, texts))
    assert tables[0] == tables[1]
