"""multi_pose (COCO keypoints) and ctdet on COCO in the port, against the
JAX package.

On seeded numpy inputs, each with its tolerance:

- `flip_lr`, `flip_lr_off`: exact; `topk_channel`: equal indices and
  scores;
- `multi_pose_decode` on seeded heads, with and without hm_hp, hp_offset
  and reg: every value within 1e-5 (indices equal);
- `multi_pose_post_process`: 1e-4;
- `MultiPoseSampler` against the JAX sampler (its cv2 warp replaced by
  the port's): every target exact in its dtype, the uint8 input equal
  (the --host_normalize f32 input within 1e-5);
- `multi_pose_loss`: loss parts and gradients 1e-5;
- one FP32 train step of the full six-head model from the conditioned
  init (test_torch_common.assert_train_step_matches_jax: each gradient
  within 5e-3 of its max);
- `MultiPoseDetector.run` (flip test; and three scales merged by
  soft_nms_39) against the JAX detector on the same pre-processed
  images: 2e-3;
- the six-head and the 80-class models carried both ways with
  `from_jax_variables` / `to_jax_variables`, heads 2e-3, and a JAX
  multi_pose `.ckpt` loaded;
- the CLIs on a synthetic coco_hp set (`cli.main`, no final eval, then
  `cli.test` scored by the keypoint COCO evaluator) and on a synthetic
  COCO set (`cli.main ctdet --dataset coco` with its final bbox eval).

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
from codenet_tpu.data import samplers as JS
from codenet_tpu.data.datasets import get_dataset as jax_get_dataset
from codenet_tpu.engine import detector as JDET
from codenet_tpu.engine.torch_import import convert_shufflenetv2
from codenet_tpu.engine.trainer import Trainer as JaxTrainer
from codenet_tpu.models import create_model as jax_create_model
from codenet_tpu.models import decode as JDEC
from codenet_tpu.models import losses as JL
from codenet_tpu.models.fused_heads import eval_forward
from codenet_tpu.utils import post_process as JPP
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
from codenet_torch.utils import post_process as TPP

cv2 = pytest.importorskip("cv2")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
POSE_HEADS = {"hm": 1, "wh": 2, "hps": 34, "reg": 2, "hm_hp": 17,
              "hp_offset": 2}
COCO_HEADS = {"hm": 80, "wh": 2, "reg": 2}
FLIP_IDX = [[1, 2], [3, 4], [5, 6], [7, 8], [9, 10], [11, 12], [13, 14],
            [15, 16]]
LR = 1.25e-4
COCO_IDS = [1, 2, 3, 18, 90]


@pytest.fixture(scope="module")
def coco_root(tmp_path_factory):
    """coco/{train,val}2017 frames (noise with filled boxes) and their
    instances_*.json (5 of COCO's category ids) and
    person_keypoints_*.json (17 joints per box, a fifth unlabelled, a
    few boxes with none)."""
    root = str(tmp_path_factory.mktemp("torch_coco"))
    r = rng(60)
    base = os.path.join(root, "coco")
    os.makedirs(os.path.join(base, "annotations"))
    for split, n in (("train", 6), ("val", 3)):
        os.makedirs(os.path.join(base, split + "2017"))
        images, anns, kanns = [], [], []
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
                ann = {"id": len(anns) + 1, "image_id": i + 1,
                       "category_id": int(r.choice(COCO_IDS)),
                       "bbox": [float(x), float(y), float(bw), float(bh)],
                       "area": float(bw * bh), "iscrowd": 0}
                anns.append(ann)
                vis = r.choice([0, 1, 2], 17, p=[0.2, 0.2, 0.6])
                if r.rand() < 0.15:
                    vis[:] = 0
                kps = np.stack([x + r.rand(17) * bw, y + r.rand(17) * bh,
                                vis], axis=1)
                kanns.append(dict(ann, category_id=1,
                                  keypoints=kps.reshape(-1).tolist(),
                                  num_keypoints=int((vis > 0).sum())))
            cv2.imwrite(os.path.join(base, split + "2017", name), img)
        for fname, a, cats in (
                ("instances", anns, COCO_IDS), ("person_keypoints", kanns,
                                                [1])):
            with open(os.path.join(base, "annotations", "{}_{}2017.json"
                                   .format(fname, split)), "w") as f:
                json.dump({"images": images, "annotations": a,
                           "categories": [{"id": c, "name": str(c)}
                                          for c in cats]}, f)
    return root


def _pose_opt(cfg, root="", extra=()):
    args = ["multi_pose", "--dataset", "coco_hp", "--arch", "shufflenetv2",
            "--input_res", "64", "--batch_size", "2", "--gpus", "-1",
            "--data_dir", root] + list(extra)
    return cfg.update_dataset_info_and_set_heads(
        cfg.parse(args), cfg.DATASET_SPECS["coco_hp"])


# -- flips, top-k, decode, post-process -------------------------------------

def test_flip_lr_and_flip_lr_off_match_jax():
    x = rng(61).randn(2, 5, 6, 17).astype(np.float32)
    off = rng(62).randn(2, 5, 6, 34).astype(np.float32)
    np.testing.assert_array_equal(
        to_np(TDET.flip_lr(torch.from_numpy(x), FLIP_IDX)),
        np.asarray(JDET.flip_lr(jnp.asarray(x), FLIP_IDX)))
    np.testing.assert_array_equal(
        to_np(TDET.flip_lr_off(torch.from_numpy(off), FLIP_IDX)),
        np.asarray(JDET.flip_lr_off(jnp.asarray(off), FLIP_IDX)))


@pytest.mark.parametrize("method,shape,k", [("pooled", (2, 32, 32, 17), 20),
                                            ("pooled", (1, 15, 17, 3), 12),
                                            ("two_stage", (2, 16, 16, 17),
                                             12)])
def test_topk_channel_matches_jax(method, shape, k):
    """Per joint top-k of peak-masked random maps (no ties among the
    selected peaks): equal indices, ys, xs and scores."""
    heat = rng(63).rand(*shape).astype(np.float32)
    ref = JDEC.topk_channel(JDEC.heat_nms(jnp.asarray(heat)), k, method)
    out = TDEC.topk_channel(TDEC.heat_nms(torch.from_numpy(heat)), k,
                            method)
    for name, a, b in zip(("score", "inds", "ys", "xs"), ref, out):
        assert tuple(b.shape) == (shape[0], shape[3], k), name
        np.testing.assert_array_equal(b.numpy(), np.asarray(a),
                                      err_msg=name)


def _pose_heads(seed, n=2, h=32, w=32):
    r = rng(seed)
    return {"hm": r.rand(n, h, w, 1).astype(np.float32),
            "wh": r.uniform(2, 20, (n, h, w, 2)).astype(np.float32),
            "hps": (r.randn(n, h, w, 34) * 4).astype(np.float32),
            "reg": r.rand(n, h, w, 2).astype(np.float32),
            "hm_hp": (r.rand(n, h, w, 17) ** 3).astype(np.float32),
            "hp_offset": r.rand(n, h, w, 2).astype(np.float32)}


@pytest.mark.parametrize("parts", ["all", "no_hm_hp", "no_hp_offset",
                                   "no_reg"])
def test_multi_pose_decode_matches_jax(parts):
    """(N, K, 40) detections of seeded heads: box, score, joints (snapped
    to hm_hp peaks where the gate allows), class; within 1e-5."""
    heads = _pose_heads(64)
    drop = {"no_hm_hp": "hm_hp", "no_hp_offset": "hp_offset",
            "no_reg": "reg"}.get(parts)
    kw = {name: heads[name] for name in ("reg", "hm_hp", "hp_offset")
          if name != drop}
    ref = np.asarray(JDEC.multi_pose_decode(
        jnp.asarray(heads["hm"]), jnp.asarray(heads["wh"]),
        jnp.asarray(heads["hps"]), k=20,
        **{k: jnp.asarray(v) for k, v in kw.items()}))
    out = TDEC.multi_pose_decode(
        torch.from_numpy(heads["hm"]), torch.from_numpy(heads["wh"]),
        torch.from_numpy(heads["hps"]), k=20,
        **{k: torch.from_numpy(v) for k, v in kw.items()}).numpy()
    assert out.shape == ref.shape == (2, 20, 40)
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-5)
    if parts == "all":
        # some joints snapped to a heatmap peak, some kept their regression
        plain = TDEC.multi_pose_decode(
            torch.from_numpy(heads["hm"]), torch.from_numpy(heads["wh"]),
            torch.from_numpy(heads["hps"]),
            reg=torch.from_numpy(heads["reg"]), k=20).numpy()
        moved = np.abs(out[..., 5:39] - plain[..., 5:39]).reshape(
            2, 20, 17, 2).max(-1) > 0
        assert 0 < moved.mean() < 1


def test_multi_pose_post_process_matches_jax():
    r = rng(65)
    dets = np.concatenate([r.uniform(0, 16, (1, 30, 4)), r.rand(1, 30, 1),
                           r.uniform(-2, 18, (1, 30, 34)),
                           np.zeros((1, 30, 1))], axis=2).astype(np.float32)
    c = [np.array([80.0, 60.0], np.float32)]
    s = [160.0]
    ref = JPP.multi_pose_post_process(dets.copy(), c, s, 16, 16)
    out = TPP.multi_pose_post_process(dets.copy(), c, s, 16, 16)
    assert len(out) == 1 and list(out[0]) == [1]
    np.testing.assert_allclose(np.asarray(out[0][1]), np.asarray(ref[0][1]),
                               rtol=0, atol=1e-4)


# -- sampler, loss, train step ----------------------------------------------

def _port_warp_in_jax_sampler(monkeypatch):
    real = JS.cv2

    def warp(img, trans, size, flags=None):
        return warp_affine_u8(img, invert_affine(trans), size[1], size[0])

    monkeypatch.setattr(JS, "cv2", types.SimpleNamespace(
        imread=real.imread, warpAffine=warp, INTER_LINEAR=real.INTER_LINEAR))


@pytest.mark.parametrize("extra", [[], ["--aug_rot", "0.5"]])
def test_rank_rows_equal_one_process(coco_root, extra):
    """Two data-parallel ranks, each keeping its rows of every batch and
    replaying the draws of the rows before them without their frames
    (data/loader.py): bit-equal to the one-process batches over three
    epochs."""
    from test_torch_common import assert_rank_rows_equal
    assert_rank_rows_equal(
        lambda: get_dataset("coco_hp", "multi_pose")(
            _pose_opt(tcfg, coco_root, extra), "train"),
        batch_size=2, epochs=3)


@pytest.mark.parametrize("extra", [[], ["--host_normalize"],
                                   ["--aug_rot", "0.5", "--rotate", "20"],
                                   ["--not_rand_crop"]],
                         ids=["device", "host_normalize", "rotate",
                              "shift_scale"])
def test_sampler_matches_jax(coco_root, monkeypatch, extra):
    """Same RandomState, same sample, train and val: crop (random or
    shift/scale), rotation, flip (joint pairs swapped), colour-aug draws,
    the warped uint8 input and every dense and fixed-size target exact;
    the --host_normalize f32 input within 1e-5, as the ctdet sampler's
    (test_torch_device_cache.py)."""
    _port_warp_in_jax_sampler(monkeypatch)
    joints = 0
    for split in ("train", "val"):
        jds = jax_get_dataset("coco_hp", "multi_pose")(
            _pose_opt(jcfg, coco_root, extra), split)
        tds = get_dataset("coco_hp", "multi_pose")(
            _pose_opt(tcfg, coco_root, extra), split)
        for i in range(len(tds)):
            a = jds.get_sample(i, rng=np.random.RandomState(70 + i))
            b = tds.get_sample(i, rng=np.random.RandomState(70 + i))
            assert set(a) == set(b)
            for k in a:
                if k == "meta":
                    for mk in ("c", "s", "gt_det", "img_id"):
                        np.testing.assert_array_equal(a[k][mk], b[k][mk])
                    continue
                if k == "input":  # host colour aug, f32 (as for ctdet)
                    assert b[k].dtype == np.float32
                    np.testing.assert_allclose(b[k], a[k], rtol=0,
                                               atol=1e-5)
                    continue
                assert np.asarray(a[k]).dtype == np.asarray(b[k]).dtype, k
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)
            assert b["hm_hp"].shape == (16, 16, 17)
            assert b["hp_ind"].dtype == np.int64 == b["hp_mask"].dtype
            joints += int(b["hp_mask"].sum())
    assert joints > 0


def test_unported_sampler_options_raise(coco_root, capsys):
    """--dense_hp trains (one step, a finite loss with its dense joint
    term); --device_cache still refuses multi_pose."""
    from codenet_torch.cli.main import main
    main(["multi_pose", "--dataset", "coco_hp", "--arch", "shufflenetv2",
          "--input_res", "64", "--gpus", "-1", "--dense_hp", "--data_dir",
          coco_root, "--exp_id", "torch_mp_dense_hp", "--batch_size", "2",
          "--num_epochs", "1", "--num_iters", "1", "--val_intervals", "-1",
          "--num_workers", "1", "--print_iter", "1"])
    out = capsys.readouterr().out
    losses = [float(ln.split(" hp_loss ")[1].split()[0])
              for ln in out.splitlines() if ln.startswith("train epoch")]
    assert len(losses) == 1 and np.isfinite(losses[0]) and losses[0] > 0
    # as in the JAX package: the image cache serves ctdet only
    with pytest.raises(SystemExit, match="ctdet"):
        main(["multi_pose", "--dataset", "coco_hp", "--arch",
              "shufflenetv2", "--input_res", "64", "--gpus", "-1",
              "--device_cache", "--data_dir", coco_root, "--exp_id",
              "torch_mp_cache"])


def _loss_batch(seed, n=2, h=8, w=8, m=5, j=17):
    r = rng(seed)
    hm = (r.rand(n, h, w, 1) * 0.9).astype(np.float32)
    hm[0, 2, 3, 0] = hm[1, 5, 1, 0] = 1.0
    hm_hp = (r.rand(n, h, w, j) * 0.9).astype(np.float32)
    hm_hp[0, 1, 1, 3] = hm_hp[1, 4, 6, 16] = 1.0
    return {"hm": hm, "hm_hp": hm_hp,
            "reg_mask": (np.arange(m) < 3).astype(np.uint8)[None]
            .repeat(n, 0),
            "ind": r.randint(0, h * w, (n, m)).astype(np.int64),
            "wh": r.uniform(1, 9, (n, m, 2)).astype(np.float32),
            "reg": r.rand(n, m, 2).astype(np.float32),
            "hps": (r.randn(n, m, 2 * j) * 3).astype(np.float32),
            "hps_mask": (r.rand(n, m, 2 * j) < 0.6).astype(np.uint8),
            "hp_offset": r.rand(n, m * j, 2).astype(np.float32),
            "hp_ind": r.randint(0, h * w, (n, m * j)).astype(np.int64),
            "hp_mask": (r.rand(n, m * j) < 0.5).astype(np.int64)}


@pytest.mark.parametrize("case", ["all", "no_hm_hp", "no_offsets",
                                  "no_reg_bbox"])
def test_multi_pose_loss_matches_jax(case):
    """Loss, its seven parts and its gradients w.r.t. the six heads."""
    opt = types.SimpleNamespace(
        hm_weight=1.0, wh_weight=0.1, off_weight=1.0, hp_weight=1.0,
        hm_hp_weight=1.0, reg_bbox=case != "no_reg_bbox",
        reg_offset=case != "no_offsets", hm_hp=case != "no_hm_hp",
        reg_hp_offset=case not in ("no_offsets", "no_hm_hp"),
        dense_hp=False)
    r = rng(66)
    outs = {k: (r.randn(2, 8, 8, c) * (3 if k in ("wh", "hps") else 1))
            .astype(np.float32) for k, c in POSE_HEADS.items()}
    batch = _loss_batch(67)

    def jloss(o):
        return JL.multi_pose_loss([o], {k: jnp.asarray(v)
                                        for k, v in batch.items()}, opt)

    (ref, rstats), rgrad = jax.value_and_grad(jloss, has_aux=True)(
        {k: jnp.asarray(v) for k, v in outs.items()})
    touts = {k: torch.from_numpy(v).requires_grad_() for k, v in outs.items()}
    loss, stats = TL.multi_pose_loss([touts], {k: torch.from_numpy(v)
                                               for k, v in batch.items()},
                                     opt)
    loss.backward()
    assert set(stats) == set(rstats)
    for k in rstats:
        np.testing.assert_allclose(float(torch.as_tensor(stats[k]).detach()),
                                   float(rstats[k]), rtol=1e-5, atol=1e-7,
                                   err_msg=k)
    for k in outs:
        g = touts[k].grad
        got = np.zeros_like(outs[k]) if g is None else to_np(g)
        np.testing.assert_allclose(got, np.asarray(rgrad[k]), rtol=1e-5,
                                   atol=1e-7, err_msg=k)


def test_train_step_matches_jax(coco_root):
    """One Adam step of the six-head model from the conditioned init on a
    sampler batch of the synthetic coco_hp set (dense hm and hm_hp,
    hp_offset at 34 joint slots per object)."""
    tds = get_dataset("coco_hp", "multi_pose")(_pose_opt(tcfg, coco_root),
                                               "train")
    batch = next(iter(DataLoader(tds, 2, shuffle=True, num_workers=1,
                                 seed=4)))
    assert int(batch["hp_mask"].sum()) >= 1
    trainer = Trainer(_pose_opt(tcfg, coco_root), device="cpu")
    trainer.init()
    raise_bn_biases(trainer.model, POSE_HEADS)
    jtr = JaxTrainer(_pose_opt(jcfg, coco_root))
    jtr.init()
    assert_train_step_matches_jax(trainer, jtr, batch, LR)


# -- weights, detector ------------------------------------------------------

@pytest.fixture(scope="module")
def pose_weights():
    model = create_model("shufflenetv2", POSE_HEADS, 64, device="cpu")
    sd = {k: v.numpy() for k, v in model.state_dict().items()}
    return perturb_variables(
        convert_shufflenetv2(sd, heads=tuple(sorted(POSE_HEADS))), seed=68)


@pytest.mark.parametrize("heads", ["pose", "coco"])
def test_weights_carry_both_ways(heads, pose_weights):
    """from_jax_variables of the JAX model's trees gives the port model
    whose heads match the JAX eval forward (2e-3 of each head's max);
    to_jax_variables gives the trees back exactly."""
    if heads == "pose":
        head_dict, variables = POSE_HEADS, pose_weights
    else:
        head_dict = COCO_HEADS
        model = create_model("shufflenetv2", head_dict, 64, device="cpu")
        sd = {k: v.numpy() for k, v in model.state_dict().items()}
        variables = perturb_variables(
            convert_shufflenetv2(sd, heads=tuple(sorted(head_dict))),
            seed=69)
    jmodel = jax_create_model("shufflenetv2", head_dict, 64)
    x = rng(70).randn(2, 64, 64, 3).astype(np.float32)
    ref = jax.jit(lambda v, x: eval_forward(jmodel, v, x))(
        variables, jnp.asarray(x))
    sd = from_jax_variables(variables)
    model = create_model("shufflenetv2", head_dict, 64, device="cpu")
    model.load_state_dict(sd)
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
        for path, v in ref_leaves.items():  # the f32 values the model held
            np.testing.assert_array_equal(got_leaves[path],
                                          np.asarray(v, np.float32))


def test_load_jax_multi_pose_ckpt(tmp_path, pose_weights):
    """A multi_pose .ckpt written by the JAX package's save_model loads
    into the six-head port model, every tensor exact."""
    from codenet_tpu.engine.checkpoint import save_model
    from codenet_torch.engine import checkpoint
    path = str(tmp_path / "model_last.ckpt")
    save_model(path, 3, pose_weights)
    model = create_model("shufflenetv2", POSE_HEADS, 64, device="cpu")
    _, epoch = checkpoint.load_model(path, model, strict=True)
    assert epoch == 3
    want = from_jax_variables(pose_weights)
    sd = model.state_dict()
    for k, v in want.items():
        assert torch.equal(sd[k], v), k


def _detectors(weights, extra):
    args = ["--flip_test", "--K", "12"] + list(extra)
    jdet = JDET.MultiPoseDetector(_pose_opt(jcfg, extra=args),
                                  variables=weights)
    tdet = TDET.detector_factory("multi_pose")(
        _pose_opt(tcfg, extra=args), state_dict=from_jax_variables(weights),
        device="cpu")
    assert isinstance(tdet, TDET.MultiPoseDetector)
    return jdet, tdet


@pytest.mark.parametrize("extra", [[], ["--test_scales", "0.5,1,1.5",
                                        "--nms"], ["--mse_loss"]],
                         ids=["flip_test", "multiscale_nms", "mse_loss"])
def test_detector_run_matches_jax(pose_weights, extra):
    """One flip-test request through `run`, the port fed the JAX
    pre-processed images: the merged (K, 39) rows (box, score, joints in
    image pixels) within 2e-3; with three scales and --nms, merged by
    soft_nms_39; after --mse_loss training (hm_hp read without its
    sigmoid, as the JAX detector reads it)."""
    jdet, tdet = _detectors(pose_weights, extra)
    frame = rng(71).randint(0, 256, (96, 128, 3)).astype(np.uint8)
    images, meta = {}, {}
    for scale in jdet.scales:
        images[scale], meta[scale] = jdet.pre_process(frame, scale)
    pre = {"image": frame, "images": images, "meta": meta}
    ref = np.asarray(jdet.run(pre)["results"][1], np.float32)
    ret = tdet.run(pre)
    out = np.asarray(ret["results"][1], np.float32)
    assert list(ret["results"]) == [1]
    assert out.shape == ref.shape == (12 * len(jdet.scales), 39)
    assert (out[:, 4] > 0).all()
    np.testing.assert_allclose(out, ref, rtol=2e-3, atol=2e-3)
    for key in ("tot", "pre", "net", "dec", "post", "merge"):
        assert ret[key] >= 0.0


# -- the CLIs ---------------------------------------------------------------

def test_cli_multi_pose_trains_then_scores_keypoints(coco_root, capsys):
    """cli.main multi_pose (2 iterations; no final eval, as in the JAX
    package) then cli.test --flip_test --batch_eval 2 (per-image, as
    in the JAX package) scored by the keypoint COCO evaluator."""
    from codenet_torch.cli.main import main
    from codenet_torch.cli.test import main as test_main
    common = ["multi_pose", "--dataset", "coco_hp", "--arch",
              "shufflenetv2", "--input_res", "64", "--gpus", "-1",
              "--num_workers", "1", "--data_dir", coco_root]
    main(common + ["--batch_size", "2", "--num_epochs", "1", "--num_iters",
                   "2", "--val_intervals", "-1", "--print_iter", "1",
                   "--exp_id", "torch_mp_cli"])
    out = capsys.readouterr().out
    losses = [float(ln.split(" loss ")[1].split()[0])
              for ln in out.splitlines() if ln.startswith("train epoch")]
    assert len(losses) == 2 and np.all(np.isfinite(losses))
    assert "hm_hp_loss" in out and "Running final eval" not in out
    ckpt = os.path.join(REPO, "exp", "multi_pose", "torch_mp_cli",
                        "model_last.pth")
    stats = test_main(common + ["--flip_test", "--batch_eval", "2",
                                "--load_model", ckpt, "--exp_id",
                                "torch_mp_cli_eval"])
    out = capsys.readouterr().out
    assert "falling back to per-image eval" in out
    assert list(stats) == ["AP", "AP50", "AP75", "APm", "APl", "AR", "AR50",
                           "AR75", "ARm", "ARl"]
    assert " AP = " in out and " ARl = " in out
    assert all(-1.0 <= v <= 1.0 for v in stats.values())
    with open(os.path.join(REPO, "exp", "multi_pose", "torch_mp_cli_eval",
                           "results.json")) as f:
        res = json.load(f)
    assert len(res) == 3 * 100 and len(res[0]["keypoints"]) == 51


def test_cli_ctdet_coco_trains_and_scores_boxes(coco_root, capsys):
    """cli.main ctdet --dataset coco: 80-class heads, 2 iterations, then
    the final eval scored by the bbox COCO evaluator (12 stats)."""
    from codenet_torch.cli.main import main
    main(["ctdet", "--dataset", "coco", "--arch", "shufflenetv2",
          "--input_res", "64", "--batch_size", "2", "--num_epochs", "1",
          "--num_iters", "2", "--val_intervals", "-1", "--num_workers", "1",
          "--print_iter", "1", "--gpus", "-1", "--data_dir", coco_root,
          "--exp_id", "torch_coco_cli"])
    out = capsys.readouterr().out
    assert "{'hm': 80, 'wh': 2, 'reg': 2}" in out
    losses = [float(ln.split(" loss ")[1].split()[0])
              for ln in out.splitlines() if ln.startswith("train epoch")]
    assert len(losses) == 2 and np.all(np.isfinite(losses))
    assert "Running final eval" in out
    for key in ("AP", "APs", "AR1", "AR100", "ARl"):
        assert " {} = ".format(key) in out, key
    with open(os.path.join(REPO, "exp", "ctdet", "torch_coco_cli",
                           "results.json")) as f:
        res = json.load(f)
    assert len(res) == 3 * 100
    assert {d["category_id"] for d in res} <= set(COCO._valid_ids)
