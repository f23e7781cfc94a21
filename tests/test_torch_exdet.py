"""exdet (ExtremeNet on COCO) in the port, against the JAX package.

On seeded numpy inputs and a synthetic COCO set whose annotations carry
`extreme_points` (instances_extreme_*.json), each with its tolerance:

- `_directional_aggregate` (both directions, both axes), `h_aggregate`,
  `v_aggregate`: exact;
- `exct_decode` at K = 6 and 8 (num_dets 1000 of the K^4 lattice),
  class-aware and agnostic, with and without the offsets, and with edge
  aggregation: the score column bit-equal, and the rows above the
  1000th score equal as a set (two lattice cells can tie in f32; torch
  and XLA order tied cells each their own way);
- `ExdetSampler` against the JAX sampler (its cv2 warp replaced by the
  port's), with and without --agnostic_ex: every target exact;
- `exdet_loss`: loss parts and gradients 1e-6;
- the nine heads at 64^2 from the JAX model's weights (2e-3 of each
  head's max) and back exactly, and a JAX exdet `.ckpt` loaded;
- one FP32 train step from the conditioned init (5e-3);
- `ExdetDetector.run` with flip test against the JAX detector on the
  same pre-processed images: per class rows within 2e-3;
- `cli.main exdet` -> `cli.quant_main exdet` -> `cli.test exdet
  --flip_test`, scored by the port's COCO evaluator (12 bbox stats).

The JAX side runs on its XLA deform path.
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
from codenet_tpu.data import samplers as JS
from codenet_tpu.data.datasets import get_dataset as jax_get_dataset
from codenet_tpu.engine import detector as JDET
from codenet_tpu.engine.torch_import import convert_shufflenetv2
from codenet_tpu.engine.trainer import Trainer as JaxTrainer
from codenet_tpu.models import create_model as jax_create_model
from codenet_tpu.models import decode as JDEC
from codenet_tpu.models import losses as JL
from codenet_tpu.models.fused_heads import eval_forward
from codenet_torch import config as tcfg
from codenet_torch.data.affine import invert_affine, warp_affine_u8
from codenet_torch.data.datasets import COCO, get_dataset
from codenet_torch.data.loader import DataLoader
from codenet_torch.engine import detector as TDET
from codenet_torch.engine.jax_weights import (from_jax_variables,
                                              to_jax_variables)
from codenet_torch.engine.trainer import Trainer
from codenet_torch.models import create_model
from codenet_torch.models import decode as TDEC
from codenet_torch.models import losses as TL

cv2 = pytest.importorskip("cv2")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PARTS = ("t", "l", "b", "r")
COCO_IDS = [1, 3, 18, 44, 90]
LR = 1.25e-4


def exdet_heads(agnostic=False, num_classes=80):
    num_hm = 1 if agnostic else num_classes
    heads = {"hm_" + p: num_hm for p in PARTS}
    heads.update({"hm_c": num_classes},
                 **{"reg_" + p: 2 for p in PARTS})
    return heads


@pytest.fixture(scope="module")
def coco_root(tmp_path_factory):
    """coco/{train,val}2017 frames (noise with filled boxes) and their
    instances_extreme_*.json: per box its four extreme points (top, left,
    bottom, right) on the box's edges, 5 of COCO's category ids."""
    root = str(tmp_path_factory.mktemp("torch_coco_extreme"))
    r = rng(120)
    base = os.path.join(root, "coco")
    os.makedirs(os.path.join(base, "annotations"))
    for split, n in (("train", 6), ("val", 3)):
        os.makedirs(os.path.join(base, split + "2017"))
        images, anns = [], []
        for i in range(n):
            w, h = (160, 120) if i % 2 == 0 else (120, 160)
            img = (r.rand(h, w, 3) * 80).astype(np.uint8)
            name = "{:012d}.png".format(i + 1)
            images.append({"id": i + 1, "file_name": name, "width": w,
                           "height": h})
            for _ in range(r.randint(1, 4)):
                bw, bh = r.randint(16, w // 2), r.randint(16, h // 2)
                x, y = r.randint(0, w - bw), r.randint(0, h - bh)
                img[y:y + bh, x:x + bw] = r.randint(100, 256, 3)
                ext = [x + r.rand() * bw, y, x, y + r.rand() * bh,
                       x + r.rand() * bw, y + bh, x + bw, y + r.rand() * bh]
                anns.append({"id": len(anns) + 1, "image_id": i + 1,
                             "category_id": int(r.choice(COCO_IDS)),
                             "bbox": [float(x), float(y), float(bw),
                                      float(bh)],
                             "area": float(bw * bh), "iscrowd": 0,
                             "extreme_points": [float(v) for v in ext]})
            cv2.imwrite(os.path.join(base, split + "2017", name), img)
        with open(os.path.join(base, "annotations",
                               "instances_extreme_{}2017.json".format(
                                   split)), "w") as f:
            json.dump({"images": images, "annotations": anns,
                       "categories": [{"id": c, "name": str(c)}
                                      for c in COCO_IDS]}, f)
    return root


def _ex_opt(cfg, root="", extra=()):
    args = ["exdet", "--dataset", "coco", "--arch", "shufflenetv2",
            "--input_res", "64", "--batch_size", "2", "--gpus", "-1",
            "--data_dir", root] + list(extra)
    return cfg.update_dataset_info_and_set_heads(
        cfg.parse(args), cfg.DATASET_SPECS["coco"])


# -- aggregates and the decode ------------------------------------------------

@pytest.mark.parametrize("axis", [1, 2])
def test_aggregates_match_jax(axis):
    x = rng(121).rand(2, 9, 11, 3).astype(np.float32)
    for reverse in (False, True):
        np.testing.assert_array_equal(
            TDEC._directional_aggregate(torch.from_numpy(x), axis,
                                        reverse).numpy(),
            np.asarray(JDEC._directional_aggregate(jnp.asarray(x), axis,
                                                   reverse)))
    name = "h_aggregate" if axis == 2 else "v_aggregate"
    np.testing.assert_array_equal(
        getattr(TDEC, name)(torch.from_numpy(x), 0.1).numpy(),
        np.asarray(getattr(JDEC, name)(jnp.asarray(x), 0.1)))


def _lattice_heats(seed, agnostic, c=5, n=2, h=16, w=16, scale=1.0):
    r = rng(seed)
    num_hm = 1 if agnostic else c
    heats = [(r.rand(n, h, w, num_hm) * scale).astype(np.float32)
             for _ in PARTS]
    heats.append(r.rand(n, h, w, c).astype(np.float32))
    regrs = [r.rand(n, h, w, 2).astype(np.float32) for _ in PARTS]
    return heats, regrs


def assert_dets_match(out, ref):
    """(N, num_dets, 14): the score column equal; the rows whose score is
    above the last kept one equal as a set (ties at the cut may pick
    other cells)."""
    assert out.shape == ref.shape
    np.testing.assert_array_equal(out[..., 4], ref[..., 4])
    for i in range(out.shape[0]):
        keep = ref[i, :, 4] > ref[i, -1, 4]
        a, b = out[i][keep], ref[i][keep]
        a = a[np.lexsort(a.T[::-1])]
        b = b[np.lexsort(b.T[::-1])]
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("agnostic", [False, True], ids=["class", "agnostic"])
@pytest.mark.parametrize("offsets", [True, False], ids=["reg", "no_reg"])
@pytest.mark.parametrize("k", [6, 8])
def test_exct_decode_matches_jax(agnostic, offsets, k):
    """num_dets 1000 of the K^4 lattice of seeded heats: scores bit-equal,
    rows equal (see assert_dets_match); some rows pass every test."""
    heats, regrs = _lattice_heats(122 + k, agnostic)
    if not offsets:
        regrs = [None] * 4
    kw = dict(k=k, agnostic=agnostic)
    ref = np.asarray(JDEC.exct_decode(
        *map(jnp.asarray, heats),
        *(None if x is None else jnp.asarray(x) for x in regrs), **kw))
    out = TDEC.exct_decode(
        *map(torch.from_numpy, heats),
        *(None if x is None else torch.from_numpy(x) for x in regrs),
        **kw).numpy()
    assert out.shape == (2, 1000, 14)
    assert_dets_match(out, ref)
    if agnostic:
        assert (out[..., 4] > 0).any()


@pytest.mark.parametrize("agnostic", [False, True], ids=["class", "agnostic"])
def test_exct_decode_aggregated_matches_jax(agnostic):
    """--aggr_weight 0.1: the edge aggregates feed the decode (heats held
    under 0.5, so that the aggregates stay under 0.8 and the min(heat, 1)
    clamp makes no plateau)."""
    heats, regrs = _lattice_heats(130, agnostic, scale=0.5)
    kw = dict(k=6, agnostic=agnostic, aggr_weight=0.1)
    ref = np.asarray(JDEC.exct_decode(*map(jnp.asarray, heats),
                                      *map(jnp.asarray, regrs), **kw))
    out = TDEC.exct_decode(*map(torch.from_numpy, heats),
                           *map(torch.from_numpy, regrs), **kw).numpy()
    assert_dets_match(out, ref)
    assert TDEC.agnex_ct_decode(
        *map(torch.from_numpy, heats), k=6).shape == (2, 1000, 14)


# -- sampler, loss -------------------------------------------------------------

def _port_warp_in_jax_sampler(monkeypatch):
    real = JS.cv2

    def warp(img, trans, size, flags=None):
        return warp_affine_u8(img, invert_affine(trans), size[1], size[0])

    monkeypatch.setattr(JS, "cv2", types.SimpleNamespace(
        imread=real.imread, warpAffine=warp, INTER_LINEAR=real.INTER_LINEAR))


@pytest.mark.parametrize("extra", [[], ["--not_rand_crop"]])
def test_rank_rows_equal_one_process(coco_root, extra):
    """Two data-parallel ranks, each keeping its rows of every batch and
    replaying the draws of the rows before them without their frames
    (data/loader.py): bit-equal to the one-process batches over three
    epochs."""
    from test_torch_common import assert_rank_rows_equal
    assert_rank_rows_equal(
        lambda: get_dataset("coco", "exdet")(
            _ex_opt(tcfg, coco_root, extra), "train"),
        batch_size=2, epochs=3)


@pytest.mark.parametrize("extra", [[], ["--agnostic_ex"], ["--not_rand_crop"],
                                   ["--host_normalize"]],
                         ids=["device", "agnostic", "shift_scale",
                              "host_normalize"])
def test_sampler_matches_jax(coco_root, monkeypatch, extra):
    """Same RandomState, same sample, train and val: crop (random or
    shift/scale), flip (left and right points swapped), colour-aug draws,
    the uint8 input, the five dense heatmaps, offsets and indices exact;
    the --host_normalize f32 input within 1e-5."""
    _port_warp_in_jax_sampler(monkeypatch)
    points = 0
    for split in ("train", "val"):
        jds = jax_get_dataset("coco", "exdet")(_ex_opt(jcfg, coco_root,
                                                       extra), split)
        tds = get_dataset("coco", "exdet")(_ex_opt(tcfg, coco_root, extra),
                                           split)
        assert tds.annot_path.endswith(
            "instances_extreme_{}2017.json".format(split))
        for i in range(len(tds)):
            a = jds.get_sample(i, rng=np.random.RandomState(130 + i))
            b = tds.get_sample(i, rng=np.random.RandomState(130 + i))
            assert set(a) == set(b)
            for k in a:
                if k == "meta":
                    for mk in ("c", "s", "gt_det", "img_id"):
                        np.testing.assert_array_equal(a[k][mk], b[k][mk])
                    continue
                if k == "input":
                    np.testing.assert_allclose(b[k], a[k], rtol=0,
                                               atol=1e-5)
                    continue
                assert np.asarray(a[k]).dtype == np.asarray(b[k]).dtype, k
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)
            assert b["hm_t"].shape == (
                16, 16, 1 if "--agnostic_ex" in extra else 80)
            points += int(b["reg_mask"].sum())
    assert points > 0


def test_exdet_loss_matches_jax():
    """ExdetLoss: loss parts and the gradients w.r.t. the nine heads."""
    opt = types.SimpleNamespace(hm_weight=1.0, off_weight=1.0,
                                reg_offset=True, mse_loss=False)
    r = rng(131)
    n, h, w, m = 2, 8, 8, 5
    outs = {k: r.randn(n, h, w, c).astype(np.float32)
            for k, c in exdet_heads(num_classes=3).items()}
    batch = {"reg_mask": (np.arange(m) < 3).astype(np.uint8)[None]
             .repeat(n, 0)}
    for p in PARTS + ("c",):
        hm = (r.rand(n, h, w, 3) * 0.9).astype(np.float32)
        hm[0, 1, 2, 0] = 1.0
        batch["hm_" + p] = hm
    for p in PARTS:
        batch["ind_" + p] = r.randint(0, h * w, (n, m)).astype(np.int64)
        batch["reg_" + p] = r.rand(n, m, 2).astype(np.float32)
    (ref, rstats), rgrad = jax.value_and_grad(
        lambda o: JL.exdet_loss([o], {k: jnp.asarray(v)
                                      for k, v in batch.items()}, opt),
        has_aux=True)({k: jnp.asarray(v) for k, v in outs.items()})
    touts = {k: torch.from_numpy(v).requires_grad_() for k, v in outs.items()}
    loss, stats = TL.exdet_loss([touts], {k: torch.from_numpy(v)
                                          for k, v in batch.items()}, opt)
    loss.backward()
    assert set(stats) == set(rstats)
    for k in rstats:
        np.testing.assert_allclose(float(torch.as_tensor(stats[k]).detach()),
                                   float(rstats[k]), rtol=1e-6, err_msg=k)
    for k in outs:
        np.testing.assert_allclose(to_np(touts[k].grad),
                                   np.asarray(rgrad[k]), rtol=0, atol=1e-6,
                                   err_msg=k)


# -- weights, train step, detector -------------------------------------------

def _weights(heads, seed):
    model = create_model("shufflenetv2", heads, 64, device="cpu")
    sd = {k: v.numpy() for k, v in model.state_dict().items()}
    return perturb_variables(
        convert_shufflenetv2(sd, heads=tuple(sorted(heads))), seed=seed)


@pytest.fixture(scope="module")
def exdet_weights():
    return _weights(exdet_heads(), 132)


@pytest.mark.parametrize("agnostic", [False, True], ids=["class", "agnostic"])
def test_weights_carry_both_ways(agnostic, exdet_weights):
    """The nine heads at 64^2: the port model from the JAX trees matches
    the JAX eval forward (2e-3 of each head's max), every `hm_*` head's
    bias at -2.19 at init and the offsets' at 0, and to_jax_variables
    gives the trees back exactly."""
    heads = exdet_heads(agnostic)
    variables = _weights(heads, 133) if agnostic else exdet_weights
    init = create_model("shufflenetv2", heads, 64, device="cpu").state_dict()
    for head in heads:
        want = -2.19 if "hm" in head else 0.0
        np.testing.assert_allclose(to_np(init[head + ".6.bias"]), want,
                                   rtol=1e-6)
    jmodel = jax_create_model("shufflenetv2", heads, 64)
    x = rng(134).randn(2, 64, 64, 3).astype(np.float32)
    ref = jax.jit(lambda v, x: eval_forward(jmodel, v, x))(
        variables, jnp.asarray(x))
    model = create_model("shufflenetv2", heads, 64, device="cpu")
    model.load_state_dict(from_jax_variables(variables))
    with torch.no_grad():
        out = model(torch.from_numpy(x))
    assert_heads_close({k: np.asarray(v) for k, v in ref.items()},
                       {k: to_np(v) for k, v in out.items()}, rel=2e-3)
    back = to_jax_variables(model.state_dict())
    for coll in ("params", "batch_stats"):
        ref_leaves = dict(jax.tree_util.tree_flatten_with_path(
            variables[coll])[0])
        got_leaves = dict(jax.tree_util.tree_flatten_with_path(back[coll])[0])
        assert set(map(str, got_leaves)) == set(map(str, ref_leaves))
        for path, v in ref_leaves.items():
            np.testing.assert_array_equal(got_leaves[path],
                                          np.asarray(v, np.float32))


def test_load_jax_exdet_ckpt(tmp_path, exdet_weights):
    from codenet_tpu.engine.checkpoint import save_model
    from codenet_torch.engine import checkpoint
    path = str(tmp_path / "model_last.ckpt")
    save_model(path, 4, exdet_weights)
    model = create_model("shufflenetv2", exdet_heads(), 64, device="cpu")
    _, epoch = checkpoint.load_model(path, model, strict=True)
    assert epoch == 4
    sd = model.state_dict()
    for k, v in from_jax_variables(exdet_weights).items():
        assert torch.equal(sd[k], v), k


def test_train_step_matches_jax(coco_root):
    """One Adam step of the nine-head model from the conditioned init on a
    sampler batch of the synthetic extreme-point set."""
    opt = _ex_opt(tcfg, coco_root)
    tds = get_dataset("coco", "exdet")(opt, "train")
    batch = next(iter(DataLoader(tds, 2, shuffle=True, num_workers=1,
                                 seed=6)))
    assert int(batch["reg_mask"].sum()) >= 1
    trainer = Trainer(opt, device="cpu")
    trainer.init()
    raise_bn_biases(trainer.model, exdet_heads())
    jtr = JaxTrainer(_ex_opt(jcfg, coco_root))
    jtr.init()
    assert_train_step_matches_jax(trainer, jtr, batch, LR)


def assert_rows_close(out, ref, tol, cut=True):
    """(n, C) rows of two decodes of slightly different heads: each row of
    `ref` (with `cut`, each scored clearly above both top-k cuts) within
    `tol` of a row of `out`. Rows of near-equal score may come in either
    order, and near the cut either decode may keep a row."""
    assert out.shape == ref.shape
    want, got = ref, out
    if cut:
        low = max(out[:, 4].min(), ref[:, 4].min()) + tol
        want, got = ref[ref[:, 4] > low], out[out[:, 4] > low - 2 * tol]
        assert len(want) > 0
    if not len(want):
        return
    dist = np.abs(want[:, None, :] - got[None, :, :]).max(-1)
    assert (dist.min(1) <= tol).all(), dist.min(1).max()


@pytest.mark.parametrize("extra", [[], ["--agnostic_ex"]],
                         ids=["class", "agnostic"])
def test_detector_run_matches_jax(exdet_weights, extra):
    """One flip-test request, the port fed the JAX pre-processed images:
    the decode of both images with the flipped copy's boxes mirrored back
    and all corners back-projected (`post_process`, 2000 rows) within
    2e-3; through `run`, per class the rows of score > 0 after soft-NMS
    and the top-100 cut within 2e-3 (a random 80-class model leaves none
    class-aware; agnostic, some)."""
    weights = _weights(exdet_heads(True), 135) if extra else exdet_weights
    args = ["--flip_test", "--K", "8", "--scores_thresh", "0.0",
            "--center_thresh", "0.0"] + extra
    jdet = JDET.ExdetDetector(_ex_opt(jcfg, extra=args), variables=weights)
    tdet = TDET.detector_factory("exdet")(
        _ex_opt(tcfg, extra=args), state_dict=from_jax_variables(weights),
        device="cpu")
    assert isinstance(tdet, TDET.ExdetDetector)
    frame = rng(136).randint(0, 256, (96, 128, 3)).astype(np.uint8)
    images, meta = jdet.pre_process(frame, 1.0)
    ref = jdet.post_process(np.asarray(jdet.process(
        images, meta["trans_inv"], 1.0)), meta)
    out = tdet.post_process(tdet.process(images, meta["trans_inv"],
                                         1.0).numpy(), meta)
    assert out.shape == (2000, 14)
    assert_rows_close(out, ref, 2e-3)

    pre = {"image": frame, "images": {1.0: images}, "meta": {1.0: meta}}
    ref = jdet.run(pre)["results"]
    ret = tdet.run(pre)
    out = ret["results"]
    assert list(out) == list(ref) == list(range(1, 81))
    rows = 0
    for j in ref:
        assert out[j].shape == ref[j].shape, j
        assert_rows_close(out[j], ref[j], 2e-3, cut=False)
        rows += len(out[j])
    assert rows <= 100 and (rows > 0) == bool(extra)
    for key in ("tot", "pre", "net", "dec", "post", "merge"):
        assert ret[key] >= 0.0


# -- the CLIs ---------------------------------------------------------------

def test_cli_exdet_trains_fine_tunes_and_scores_boxes(coco_root, capsys):
    """cli.main exdet (2 iterations, no final eval, as in the JAX
    package), cli.quant_main exdet from its checkpoint, then cli.test
    exdet --flip_test scored by the bbox COCO evaluator (12 stats)."""
    from codenet_torch.cli.main import main
    from codenet_torch.cli.quant_main import main as quant_main
    from codenet_torch.cli.test import main as test_main
    common = ["exdet", "--dataset", "coco", "--arch", "shufflenetv2",
              "--input_res", "64", "--gpus", "-1", "--num_workers", "1",
              "--data_dir", coco_root]
    train = ["--batch_size", "2", "--num_epochs", "1", "--num_iters", "2",
             "--val_intervals", "-1", "--print_iter", "1"]
    main(common + train + ["--exp_id", "torch_exdet_cli"])
    out = capsys.readouterr().out
    losses = [float(ln.split(" loss ")[1].split()[0])
              for ln in out.splitlines() if ln.startswith("train epoch")]
    assert len(losses) == 2 and np.all(np.isfinite(losses))
    assert "off_loss" in out and "Running final eval" not in out

    def ckpt(exp_id):
        return os.path.join(REPO, "exp", "exdet", exp_id, "model_last.pth")
    quant_main(common + train + ["--exp_id", "torch_exdet_qat",
                                 "--load_model", ckpt("torch_exdet_cli")])
    assert "No param" in capsys.readouterr().out
    stats = test_main(common + ["--flip_test", "--K", "10", "--resume-quantize",
                                "--load_model", ckpt("torch_exdet_qat"),
                                "--exp_id", "torch_exdet_eval"])
    out = capsys.readouterr().out
    assert len(stats) == 12
    for key in ("AP", "APs", "AR1", "AR100", "ARl"):
        assert " {} = ".format(key) in out, key
    assert all(-1.0 <= v <= 1.0 for v in stats.values())
    with open(os.path.join(REPO, "exp", "exdet", "torch_exdet_eval",
                           "results.json")) as f:
        res = json.load(f)
    assert {d["category_id"] for d in res} <= set(COCO._valid_ids)
    assert all(len(d["bbox"]) == 4 for d in res)
