"""The port's analysis, benchmark and data tools (tools_torch/
calc_coverage.py, bench_loader.py, layer_bench.py, merge_pascal_json.py,
convert_kitti_to_coco.py, convert_hourglass_weight.py,
convert_torch_ckpt.py).

calc_coverage prints the JAX package's tool's table, line for line, on a
synthetic COCO file; bench_loader and layer_bench (--device cpu) run at a
tiny size and print one well-formed JSON line per entry. The four data
and checkpoint tools run beside the JAX package's on the same seeded
inputs: equal JSON files, an equal state_dict, and for
convert_torch_ckpt equal weights once each package loads its own
output into the same initialised model.
"""

import contextlib
import importlib.util
import io
import json
import os

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _tool(path):
    name = "tool_" + os.path.splitext(os.path.basename(path))[0] \
        + "_" + os.path.basename(os.path.dirname(path))
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(REPO, path))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _run(main, argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        main(argv)
    return out.getvalue().splitlines()


def _coco_file(path, seed=60, n_images=12):
    """Images of mixed sizes with 0-6 boxes each over 4 classes, some
    sharing a centre cell (the collisions the centre-point recall
    counts)."""
    r = np.random.RandomState(seed)
    images, anns = [], []
    for i in range(n_images):
        w, h = [(640, 480), (480, 640), (500, 375)][i % 3]
        images.append({"id": i + 1, "width": w, "height": h,
                       "file_name": "{:06d}.png".format(i + 1)})
        for _ in range(r.randint(0, 7)):
            bw, bh = r.uniform(4, w / 2), r.uniform(4, h / 2)
            x, y = r.uniform(0, w - bw), r.uniform(0, h - bh)
            anns.append({"id": len(anns) + 1, "image_id": i + 1,
                         "category_id": int(r.randint(1, 5)),
                         "bbox": [x, y, bw, bh], "area": bw * bh,
                         "iscrowd": 0})
        if i % 4 == 0 and anns:  # a twin of the last box: one collision
            twin = dict(anns[-1], id=len(anns) + 1)
            x, y, bw, bh = twin["bbox"]  # shrunk about the same centre
            twin["bbox"] = [x + 0.01 * bw, y + 0.01 * bh, 0.98 * bw,
                            0.98 * bh]
            anns.append(twin)
    path.write_text(json.dumps({
        "images": images, "annotations": anns,
        "categories": [{"id": c, "name": str(c)} for c in range(1, 5)]}))
    return str(path)


@pytest.mark.parametrize("argv", [[], ["--input_res", "256", "--down_ratio",
                                       "8", "--iou", "0.3", "0.5", "0.9"]],
                         ids=["default", "res256_stride8"])
def test_calc_coverage_matches_jax(tmp_path, argv):
    ann = _coco_file(tmp_path / "instances.json")
    ours = _run(_tool("tools_torch/calc_coverage.py").main, [ann] + argv)
    ref = _run(_tool("tools_tpu/calc_coverage.py").main, [ann] + argv)
    assert ours == ref
    assert len(ours) == 2 + 2 * (len(argv[-3:]) if argv else 2)
    assert "collision-free recall" in ours[-1]
    assert float(ours[-1].split("=")[1]) < 1.0


def test_bench_loader_runs_tiny():
    lines = _run(_tool("tools_torch/bench_loader.py").main,
                 ["--input_res", "64", "--batch", "2", "--images", "4",
                  "--epochs", "1", "--workers", "1,2", "--img_w", "96",
                  "--img_h", "64"])
    rows = [json.loads(line) for line in lines if line.startswith("{")]
    assert rows[0]["host_cpus"] >= 1
    assert [r["workers"] for r in rows[1:]] == [1, 2]
    for r in rows[1:]:
        assert r["images"] == 4 and r["img_per_s"] > 0


@pytest.mark.parametrize("mode,names", [
    ("deform", ["deform_fwd[float32] deconv0 8x8x1024",
                "deform_fwd+bwd[float32] deconv0 8x8x1024",
                "deform_fwd[float32] deconv1 16x16x256",
                "deform_fwd+bwd[float32] deconv1 16x16x256",
                "deform_fwd[float32] deconv2 32x32x128",
                "deform_fwd+bwd[float32] deconv2 32x32x128",
                "deform_fwd[float32] 512-deconv2 64x64x128",
                "deform_fwd+bwd[float32] 512-deconv2 64x64x128"]),
    ("heads", ["heads fused", "heads per-head", "net neck only",
               "net full (fused heads)"]),
    ("decode", ["ctdet_decode"])])
def test_layer_bench_cpu_runs_tiny(mode, names):
    lines = _run(_tool("tools_torch/layer_bench.py").main,
                 [mode, "--device", "cpu", "--batch", "1", "--res", "8",
                  "--dtype", "float32", "--iters", "1", "--warmup", "0"])
    rows = [json.loads(line) for line in lines]
    assert [r["name"] for r in rows] == names
    for r in rows:
        assert r["ms"] > 0 and r["img_per_s"] > 0


def _same_output(tmp_path, name, argv_of, suffixes=("", "")):
    """Run tools_tpu/<name> and tools_torch/<name> with argv_of(out
    path), each output path ending in its suffix; returns the two output
    paths and printed lines."""
    outs, lines = [], []
    for pkg, suffix in zip(("tools_tpu", "tools_torch"), suffixes):
        out = str(tmp_path / "{}_{}{}".format(pkg, name, suffix))
        lines.append(_run(_tool(os.path.join(pkg, name + ".py")).main,
                          argv_of(out)))
        outs.append(out)
    return outs, lines


def _json(path):
    with open(path) as f:
        return json.load(f)


def test_merge_pascal_json_matches_jax(tmp_path):
    inputs = []
    for seed in (61, 62, 63):
        path = tmp_path / "voc{}.json".format(seed)
        _coco_file(path, seed=seed, n_images=5 + seed % 3)
        inputs.append(str(path))
    (jax_out, port_out), (jax_lines, port_lines) = _same_output(
        tmp_path, "merge_pascal_json",
        lambda out: inputs + ["--out", out])
    merged = _json(port_out)
    assert merged == _json(jax_out)
    assert len({i["id"] for i in merged["images"]}) == len(merged["images"])
    assert port_lines == [line.replace(jax_out, port_out)
                          for line in jax_lines]


def _kitti_raw(root, ids, seed=64):
    """KITTI's training/label_2 and training/calib files for `ids`, with
    lines of every class, a short line and an unknown class."""
    r = np.random.RandomState(seed)
    classes = ["Car", "Pedestrian", "Cyclist", "Van", "DontCare", "Tram"]
    for sub in ("label_2", "calib"):
        os.makedirs(os.path.join(root, "training", sub))
    for sid in ids:
        with open(os.path.join(root, "training", "label_2",
                               sid + ".txt"), "w") as f:
            for _ in range(r.randint(1, 6)):
                x1, y1 = r.uniform(0, 1100), r.uniform(0, 300)
                vals = [r.uniform(0, 1), r.randint(0, 3), r.uniform(-3, 3),
                        x1, y1, x1 + r.uniform(5, 140),
                        y1 + r.uniform(5, 70), *r.uniform(0.5, 4, 3),
                        *r.uniform(-20, 40, 3), r.uniform(-3, 3)]
                f.write(" ".join([classes[r.randint(len(classes))]]
                                 + ["{:.2f}".format(v) for v in vals])
                        + "\n")
            f.write("Misc 0.00 0\n")  # too short: skipped
            f.write("Bus " + " ".join(["1.00"] * 14) + "\n")
        with open(os.path.join(root, "training", "calib",
                               sid + ".txt"), "w") as f:
            for row in ("P0", "P1", "P2", "P3"):
                f.write(row + ": " + " ".join(
                    "{:.6e}".format(v) for v in r.uniform(-700, 700, 12))
                        + "\n")


def test_convert_kitti_to_coco_matches_jax(tmp_path):
    ids = ["000003", "000010", "000011", "000042"]
    root = str(tmp_path / "kitti")
    _kitti_raw(root, ids)
    split = str(tmp_path / "train.txt")
    with open(split, "w") as f:
        f.write("\n".join(ids) + "\n")
    (jax_out, port_out), _ = _same_output(
        tmp_path, "convert_kitti_to_coco",
        lambda out: ["--kitti_dir", root, "--split_file", split, "--out",
                     os.path.join(out, "kitti_3dop_train.json"),
                     "--img_w", "1224", "--img_h", "370"])
    got = _json(os.path.join(port_out, "kitti_3dop_train.json"))
    assert got == _json(os.path.join(jax_out, "kitti_3dop_train.json"))
    assert len(got["images"]) == 4 and len(got["annotations"]) > 4


def test_convert_hourglass_weight_matches_jax(tmp_path):
    import torch
    r = np.random.RandomState(65)
    heads = ["t_heats", "l_heats", "b_heats", "r_heats", "ct_heats",
             "t_regrs", "l_regrs", "b_regrs", "r_regrs"]
    sd = {"module.{}.{}.{}.weight".format(h, s, i):
          torch.from_numpy(r.randn(3, 2).astype(np.float32))
          for h in heads for s in (0, 1) for i in (0, 1)}
    sd["module.pre.0.conv.weight"] = torch.zeros(2, 3)
    src = str(tmp_path / "ExtremeNet.pkl")
    torch.save({"state_dict": sd}, src)
    (jax_out, port_out), _ = _same_output(
        tmp_path, "convert_hourglass_weight", lambda out: [src, out])
    got = torch.load(port_out, weights_only=True)
    want = torch.load(jax_out, weights_only=True)
    assert got["epoch"] == want["epoch"] == 0
    assert list(got["state_dict"]) == list(want["state_dict"])
    for k, v in want["state_dict"].items():
        assert torch.equal(got["state_dict"][k], v), k
    assert "module.hm_c.0.0.weight" in got["state_dict"]


@pytest.mark.parametrize("kind", ["reference", "pytorchcv"])
def test_convert_torch_ckpt_matches_jax(tmp_path, kind):
    """A reference .pth (DataParallel prefixes, BN batch counters) and a
    pytorchcv ImageNet ShuffleNetV2: the JAX tool's .ckpt loaded by the
    JAX loader and the port tool's .pth loaded by the port's, into the
    same initialised model, give equal weights."""
    import jax
    import torch
    from test_torch_faults import _pytorchcv_checkpoint
    from codenet_tpu.engine import checkpoint as jckpt
    from codenet_torch.engine import checkpoint
    from codenet_torch.engine.jax_weights import (from_jax_variables,
                                                  to_jax_variables)
    from codenet_torch.models import create_model
    model = create_model("shufflenetv2", {"hm": 20, "wh": 2, "reg": 2}, 64,
                         device="cpu",
                         generator=torch.Generator().manual_seed(4))
    init = {k: v.clone() for k, v in model.state_dict().items()}
    src = str(tmp_path / "src.pth")
    flags = []
    if kind == "pytorchcv":
        _pytorchcv_checkpoint(model, src)
        flags = ["--pytorchcv_backbone"]
    else:
        trained = create_model("shufflenetv2", {"hm": 20, "wh": 2,
                                                "reg": 2, "dep": 1}, 64,
                               device="cpu",
                               generator=torch.Generator().manual_seed(5))
        r = np.random.RandomState(66)
        torch.save({"epoch": 7, "state_dict": {
            "module." + k: v + torch.from_numpy(r.rand(*v.shape).astype(
                np.float32)) if v.is_floating_point() else v
            for k, v in trained.state_dict().items()}}, src)
    (jax_out, port_out), _ = _same_output(
        tmp_path, "convert_torch_ckpt", lambda out: [src, out] + flags,
        suffixes=(".ckpt", ".pth"))
    jvars, jepoch, _ = jckpt.load_model(jax_out, to_jax_variables(init))
    want = from_jax_variables(jax.tree_util.tree_map(np.asarray, jvars))
    _, epoch = checkpoint.load_model(port_out, model)
    assert epoch == jepoch == (0 if kind == "pytorchcv" else 7)
    got = model.state_dict()
    moved = 0
    for key, value in got.items():
        if key.endswith("num_batches_tracked"):
            continue
        np.testing.assert_array_equal(value.numpy(), want[key].numpy(),
                                      err_msg=key)
        moved += not torch.equal(value, init[key])
    assert moved == (280 if kind == "pytorchcv" else len([
        k for k in got if not k.endswith("num_batches_tracked")]))
