"""tools_torch/run_configs_ae.py and summarize_results.py: the paper's
configs a-e through the port's CLIs, and the table they feed.

The driver's command lines are held equal to tools_tpu/run_configs_ae.py's
(every subprocess call captured in both; the same configs, flags, stages
and exp ids, modulo the entry point, the checkpoint suffix and the
port's --gpus), its resume markers on the port's files, --dry_run and
the stage seconds it records; the summary's scores equal to
tools_tpu/summarize_results.py's on the same results files.
"""

import importlib.util
import json
import os
import subprocess

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STAGES = ["fp32_train", "qat_finetune", "eval_fakequant", "eval_int8",
          "export_w4a8"]


def _load(relpath, name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(REPO, relpath))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(scope="module")
def drivers():
    return {"jax": _load("tools_tpu/run_configs_ae.py", "jax_configs_ae"),
            "port": _load("tools_torch/run_configs_ae.py",
                          "port_configs_ae")}


@pytest.fixture
def voc_dir(tmp_path):
    os.makedirs(tmp_path / "data" / "voc")
    return str(tmp_path / "data")


def _captured(tool, root, monkeypatch):
    """Run-nothing subprocess.call for `tool` with its REPO at `root`:
    records each command and makes its exp dir."""
    monkeypatch.setattr(tool, "REPO", root)
    calls = []

    def call(cmd, cwd=None, **kw):
        calls.append(list(cmd))
        os.makedirs(os.path.join(root, "exp", "ctdet",
                                 cmd[cmd.index("--exp_id") + 1]),
                    exist_ok=True)
        return 0
    monkeypatch.setattr(subprocess, "call", call)
    return calls


def _normalised(cmd):
    """(entry point, arguments): python main.py and -m codenet_torch.cli
    .main -> "main", tools_tpu/ and tools_torch/export_w4a8.py ->
    "export_w4a8"."""
    if cmd[1] == "-m":
        return cmd[2].rsplit(".", 1)[1], cmd[3:]
    return os.path.basename(cmd[1])[:-len(".py")], cmd[2:]


@pytest.mark.parametrize("config", list("abcde"))
def test_build_commands_match_jax(drivers, voc_dir, tmp_path, monkeypatch,
                                  config):
    """Each config's five stages: the JAX driver's command lines, entry
    points aside; with --gpus every stage gets it."""
    argv = ["--configs", config, "--data_dir", voc_dir, "--device_cache",
            "--lr", "0.001", "--fp32_epochs", "3", "--qat_epochs", "5",
            "--lr_step", "2,4", "--save_intervals", "100",
            "--val_intervals", "-1"]
    out = {}
    for name, tool in drivers.items():
        root = str(tmp_path / name)
        calls = _captured(tool, root, monkeypatch)
        assert tool.main(argv) == 0
        out[name] = [_normalised(c) for c in calls]
    assert [e for e, _ in out["port"]] == ["main", "quant_main", "test",
                                           "test", "export_w4a8"]
    assert out["port"] == out["jax"]
    assert all("--exp_id" in a and
               a[a.index("--exp_id") + 1] ==
               "pascal_shufflenetv2_config_" + config for _, a in out["port"])

    calls = _captured(drivers["port"], str(tmp_path / "gpus"), monkeypatch)
    drivers["port"].main(argv + ["--gpus", "-1"])
    for (_, plain), cmd in zip(out["port"], calls):
        _, args = _normalised(cmd)
        i = args.index("--gpus")
        assert args[i + 1] == "-1"
        assert args[:i] + args[i + 2:] == plain


def test_stage_done_reads_port_markers(drivers, tmp_path):
    """A stage is done once its port marker exists, and none is before
    model_last.pth does (a JAX .ckpt does not count)."""
    tool = drivers["port"]
    exp = tmp_path / "exp"
    os.makedirs(exp)
    markers = {"fp32_train": ".fp32_done", "qat_finetune": ".qat_done",
               "eval_fakequant": "results_fakequant.json",
               "eval_int8": "results_int8.json",
               "export_w4a8": "model_w4a8.npz"}
    for name in markers.values():
        (exp / name).write_text("")
    (exp / "model_last.ckpt").write_text("")
    assert not any(tool.stage_done(str(exp), s, None) for s in STAGES)
    (exp / "model_last.pth").write_text("")
    assert all(tool.stage_done(str(exp), s, None) for s in STAGES)
    for stage, name in markers.items():
        (exp / name).unlink()
        assert not tool.stage_done(str(exp), stage, None)


def test_driver_resumes_records_seconds_and_dry_run(drivers, voc_dir,
                                                    tmp_path, monkeypatch,
                                                    capsys):
    """--dry_run prints the 5 stages of each config and runs nothing; a
    run marks its stages, keeps each eval's results.json under its tag
    and records every stage's seconds; a second run skips them all and
    keeps the seconds."""
    tool = drivers["port"]
    root = str(tmp_path / "repo")
    calls = _captured(tool, root, monkeypatch)
    assert tool.main(["--configs", "b,d", "--data_dir", voc_dir,
                      "--dry_run"]) == 0
    printed = [ln for ln in capsys.readouterr().out.splitlines()
               if ln.startswith("[")]
    assert calls == [] and len(printed) == 10
    assert not os.path.exists(tool.summary_path())

    def call(cmd, cwd=None, **kw):
        calls.append(cmd)
        exp_dir = os.path.join(root, "exp", "ctdet",
                               cmd[cmd.index("--exp_id") + 1])
        os.makedirs(exp_dir, exist_ok=True)
        for name in ("model_last.pth", "results.json"):
            with open(os.path.join(exp_dir, name), "w") as f:
                f.write(str(len(calls)))
        if "export_w4a8" in " ".join(cmd):
            open(os.path.join(exp_dir, "model_w4a8.npz"), "w").close()
        return 0
    monkeypatch.setattr(subprocess, "call", call)
    assert tool.main(["--configs", "d", "--data_dir", voc_dir]) == 0
    exp_dir = os.path.join(root, "exp", "ctdet",
                           "pascal_shufflenetv2_config_d")
    with open(os.path.join(exp_dir, "results_fakequant.json")) as f:
        assert f.read() == "3"
    with open(os.path.join(exp_dir, "results_int8.json")) as f:
        assert f.read() == "4"
    with open(tool.summary_path()) as f:
        summary = json.load(f)
    assert list(summary["d"]["stage_seconds"]) == STAGES
    assert summary["d"]["target_ap50"] == 67.1
    assert tool.main(["--configs", "d", "--data_dir", voc_dir]) == 0
    assert len(calls) == 5
    assert "done already, skipping" in capsys.readouterr().out
    with open(tool.summary_path()) as f:
        assert json.load(f)["d"]["stage_seconds"] == \
            summary["d"]["stage_seconds"]


def test_summarize_scores_equal_jax(tmp_path, monkeypatch):
    """Both summaries re-score the same results_fakequant.json and
    results_int8.json of configs a and d against the same ground truth:
    equal APs; the port writes exp/RESULTS_torch.md under its REPO and
    refuses RESULTS.md."""
    import sys
    sys.path.insert(0, os.path.join(REPO, "tools_torch"))
    from synthetic_data import make_voc_dataset
    data = str(tmp_path / "data")
    make_voc_dataset(data, num_images=2, img_w=96, img_h=72, seed=3,
                     test_images=6)
    with open(os.path.join(data, "voc", "annotations",
                           "pascal_test2007.json")) as f:
        gt = json.load(f)
    ids = sorted(i["id"] for i in gt["images"])
    r = np.random.RandomState(5)
    root = str(tmp_path / "repo")
    for config in ("a", "d"):
        exp_dir = os.path.join(root, "exp", "ctdet",
                               "pascal_shufflenetv2_config_" + config)
        os.makedirs(exp_dir)
        for tag in ("fakequant", "int8"):
            dets = [[[] for _ in ids] for _ in range(21)]
            for ann in gt["annotations"]:
                x, y, w, h = ann["bbox"]
                jit = r.uniform(-4, 4, 4)
                dets[ann["category_id"]][ids.index(ann["image_id"])].append(
                    [x + jit[0], y + jit[1], x + w + jit[2],
                     y + h + jit[3], float(r.rand())])
                cls = int(r.randint(1, 21))
                dets[cls][ids.index(ann["image_id"])].append(
                    [x, y, x + w / 2, y + h / 2, float(r.rand())])
            with open(os.path.join(exp_dir, "results_{}.json".format(tag)),
                      "w") as f:
                json.dump(dets, f)
    tools = {"jax": _load("tools_tpu/summarize_results.py",
                          "jax_summarize"),
             "port": _load("tools_torch/summarize_results.py",
                           "port_summarize")}
    scores = {}
    for name, tool in tools.items():
        monkeypatch.setattr(tool, "REPO", root)
        scores[name] = {c: tool.score_config(c, data) for c in "abcde"}
    for c in "bce":
        assert scores["port"][c] is None and scores["jax"][c] is None
    for c in "ad":
        for tag in ("fakequant", "int8"):
            assert scores["port"][c][tag] == scores["jax"][c][tag]
        assert 0 < scores["port"][c]["fakequant"]["ap50_all20"] < 1
    port = tools["port"]
    assert port.main(["--data_dir", data]) == 0
    with open(os.path.join(root, "exp", "RESULTS_torch.md")) as f:
        table = f.read()
    ap = scores["port"]["d"]["fakequant"]["ap50_all20"]
    assert "| d | 512, stride 4, 2x (--w2) | {:.4f}".format(ap) in table
    assert port.main(["--data_dir", data, "--out",
                      os.path.join(root, "RESULTS.md")]) == 2
