"""tools_torch/synthetic_regression.py: the JAX package's synthetic
accuracy regression through the port's CLIs.

The stages' command lines are held equal to those of
tools_tpu/synthetic_regression.py (the same recipe, flags and order,
modulo the entry point, `--gpus` and the checkpoint suffix), with every
subprocess call captured; then a tiny chain runs for real on the CPU on
PNG files: FP32, QAT and clamp-trained QAT training, the eight evals and
the seven deltas.
"""

import importlib.util
import json
import math
import os
import shutil
import subprocess

import pytest

pytest.importorskip("cv2")  # tests/synthetic.py writes the JAX set with it

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _load(relpath, name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(REPO, relpath))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(scope="module")
def tools():
    return {"jax": _load("tools_tpu/synthetic_regression.py",
                         "jax_synthetic_regression"),
            "port": _load("tools_torch/synthetic_regression.py",
                          "port_synthetic_regression")}


def _captured(tool, root, monkeypatch):
    """Run-nothing subprocess.call for `tool` with its REPO at `root`:
    records each command; a test command writes an empty results.json
    (21 classes x the held-out images) where the scorer reads it."""
    monkeypatch.setattr(tool, "REPO", root)
    calls = []

    def call(cmd, cwd=None, **kw):
        calls.append(list(cmd))
        exp_dir = os.path.join(root, "exp", "ctdet",
                               cmd[cmd.index("--exp_id") + 1])
        os.makedirs(exp_dir, exist_ok=True)
        if "--resume" in cmd:
            gt = os.path.join(cmd[cmd.index("--data_dir") + 1], "voc",
                              "annotations", "pascal_test2007.json")
            with open(gt) as f:
                n = len(json.load(f)["images"])
            with open(os.path.join(exp_dir, "results.json"), "w") as f:
                json.dump([[[] for _ in range(n)] for _ in range(21)], f)
        return 0
    monkeypatch.setattr(subprocess, "call", call)
    return calls


def _normalised(cmd):
    """(entry point, arguments): python main.py / -m codenet_torch.cli.main
    -> "main"; the port's --gpus pair dropped; a .ckpt path as .pth."""
    if cmd[1] == "-m":
        entry, args = cmd[2].rsplit(".", 1)[1], cmd[3:]
    else:
        entry, args = cmd[1][:-len(".py")], cmd[2:]
    if "--gpus" in args:
        i = args.index("--gpus")
        args = args[:i] + args[i + 2:]
    return entry, [a[:-len(".ckpt")] + ".pth" if a.endswith(".ckpt")
                   else a for a in args]


@pytest.mark.parametrize("harness", ["run_deltas", "run"])
def test_stage_commands_equal_jax_tool(tools, tmp_path, monkeypatch,
                                       harness):
    """Both tools' run_deltas (and run) on one small set: the same stages
    and evals, in order, with the same arguments."""
    data = str(tmp_path / "data")
    got = {}
    for name, tool in tools.items():
        root = str(tmp_path / name)
        calls = _captured(tool, root, monkeypatch)
        if harness == "run_deltas":
            kw = dict(train_images=3, test_images=2, input_res=64,
                      batch_size=2, num_epochs=10, qat_epochs=5,
                      data_root=data,
                      out_json=str(tmp_path / (name + ".json")))
            if name == "port":
                kw["gpus"] = "-1"
            payload, _ = tool.run_deltas(**kw)
            assert payload["aps"] == dict.fromkeys(payload["aps"], 0.0)
        else:
            kw = dict(train_images=3, test_images=2, input_res=64,
                      batch_size=2, num_epochs=10, data_root=data)
            if name == "port":
                kw["gpus"] = "-1"
            assert tool.run(**kw)[0] == 0.0
        got[name] = calls
    assert len(got["port"]) == (11 if harness == "run_deltas" else 2)
    assert all(cmd[cmd.index("--gpus") + 1] == "-1" for cmd in got["port"])
    jax_root, port_root = str(tmp_path / "jax"), str(tmp_path / "port")
    want = [_normalised([a.replace(jax_root, port_root) for a in cmd])
            for cmd in got["jax"]]
    assert [_normalised(cmd) for cmd in got["port"]] == want
    if harness == "run_deltas":
        assert tools["port"].DELTA_BANDS == tools["jax"].DELTA_BANDS


def test_tiny_chain_on_png_files_gives_aps_and_deltas(tools, tmp_path):
    """8 train and 4 held-out images at 64^2, 2 FP32 and 1 + 1 QAT
    epochs, on the CPU: every stage ends with exit code 0, the payload
    holds eight APs in [0, 1] and the seven deltas, and the set on disk
    is PNG."""
    tool = tools["port"]
    prefix = "pytest_synthreg_{}".format(os.getpid())
    out_json = str(tmp_path / "deltas.json")
    try:
        payload, data = tool.run_deltas(
            train_images=8, test_images=4, input_res=64, batch_size=4,
            num_epochs=2, qat_epochs=1, data_root=str(tmp_path / "data"),
            out_json=out_json, gpus="-1", exp_prefix=prefix)
    finally:
        for suffix in ("_fp32", "_qat", "_qatct"):
            shutil.rmtree(os.path.join(REPO, "exp", "ctdet",
                                       prefix + suffix),
                          ignore_errors=True)
    with open(out_json) as f:
        assert json.load(f) == json.loads(json.dumps(payload))
    aps = payload["aps"]
    assert list(aps) == ["fp32", "fp32_flip", "bf16", "qat", "qat_clamped",
                         "int8", "qat_ct", "int8_ct"]
    assert all(0.0 <= v <= 1.0 and math.isfinite(v) for v in aps.values())
    assert set(payload["deltas"]) == set(tool.DELTA_BANDS)
    assert payload["deltas"]["int8_vs_clamped"] == \
        aps["int8"] - aps["qat_clamped"]
    assert set(payload["violations"]) <= set(tool.DELTA_BANDS)
    assert len(payload["seconds"]) == 11
    assert payload["config"]["frames"] == "png"
    images = os.listdir(os.path.join(data, "voc", "images"))
    assert len(images) == 12 and all(f.endswith(".png") for f in images)


def test_device_cache_adds_the_flag_to_the_training_stages_only(
        tools, tmp_path, monkeypatch):
    """run_deltas(device_cache=True), the --smoke size's option: the same
    commands, with --device_cache on the three training stages and on no
    eval."""
    tool = tools["port"]
    got = {}
    for cache in (False, True):
        root = str(tmp_path / str(cache))
        calls = _captured(tool, root, monkeypatch)
        tool.run_deltas(train_images=3, test_images=2, input_res=64,
                        batch_size=2, num_epochs=10, qat_epochs=5,
                        data_root=str(tmp_path / "data"), gpus="-1",
                        out_json=str(tmp_path / "d.json"),
                        device_cache=cache)
        got[cache] = [[a.replace(root, "ROOT") for a in cmd]
                      for cmd in calls]
    assert [cmd.count("--device_cache") for cmd in got[True]] == \
        [1, 1, 1] + [0] * 8
    assert [[a for a in cmd if a != "--device_cache"]
            for cmd in got[True]] == got[False]


def _payload(tool, **aps):
    base = dict(fp32=0.25, fp32_flip=0.26, bf16=0.25, qat=0.30,
                qat_clamped=0.30, int8=0.30, qat_ct=0.31, int8_ct=0.31)
    base.update(aps)
    return {"aps": base, "deltas": {
        "int8_vs_clamped": base["int8"] - base["qat_clamped"],
        "bf16_vs_fp32": base["bf16"] - base["fp32"]}}


@pytest.mark.parametrize("aps,failed", [
    ({}, []),
    ({"int8": 0.0}, ["int8_vs_clamped"]),
    ({"qat_clamped": 0.02, "int8": 0.0},
     ["qat_clamped AP >= 0.1"]),
    ({"fp32": 0.05, "bf16": 0.04}, ["fp32 AP >= 0.1"]),
    ({"bf16": 0.0}, ["bf16_vs_fp32"]),
    ({"qat": float("nan")}, ["qat"]),
], ids=["healthy", "int8-zero", "clamped-under-floor", "fp32-under-floor",
        "bf16-zero", "nan"])
def test_smoke_failures_need_aps_above_the_floor(tools, aps, failed):
    """The --smoke checks: int8 at 0 fails its band, and an fp32 or
    clamped fake-quant AP under SMOKE_MIN_AP fails by itself, so that a
    band never holds only because both APs it subtracts are near 0."""
    tool = tools["port"]
    assert tool.SMOKE_MIN_AP == 0.1
    assert tool.smoke_failures(_payload(tool, **aps)) == failed
