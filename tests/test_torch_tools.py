"""The port's analysis and benchmark tools (tools_torch/calc_coverage.py,
bench_loader.py, layer_bench.py).

calc_coverage prints the JAX package's tool's table, line for line, on a
synthetic COCO file; bench_loader and layer_bench (--device cpu) run at a
tiny size and print one well-formed JSON line per entry.
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
