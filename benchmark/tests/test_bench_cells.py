"""Whole runs of the harness on the CPU at a tiny size, past its look for
a card: cells added as fixture files in a temporary copy, on ShuffleNetV2
and on an architecture added by its module alone (res_18), are found and
run without an edit to any file; a sound run comes out correct; the
control and each fault the cells can have come out not correct against
the limits the real cells hold."""

import pytest

from benchmark import readings
from benchmark.harness import cell as C
from benchmark.harness import compare, probe

from . import tiny

SEED = 2 ** 31 + 2 ** 30 + 17


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny.make(tmp_path_factory.mktemp("bench"))


def run(root, name, faults=()):
    cell = C.Cell(name, root=root)
    spans = probe.Spans()
    rec = C.run(cell, SEED, 1.0, False, "cpu", spans, faults)
    return cell, rec, spans


@pytest.fixture(scope="module")
def sound(root):
    """The sound run of a fixture cell, made once for the module's tests
    that read it: (cell, record, spans)."""
    runs = {}

    def get(name):
        if name not in runs:
            runs[name] = run(root, name)
        return runs[name]
    return get


CELLS = ["tiny_train", "tiny_serve", "tiny_res_train", "tiny_res_serve"]


@pytest.mark.parametrize("name", CELLS)
def test_fixture_cell_is_found_and_a_sound_run_is_correct(sound, name):
    cell, rec, spans = sound(name)
    values = C.end_to_end(cell, rec, 1.0)
    assert set(values) == {m["name"] for m in cell.end_to_end}
    assert compare.passed(rec["checks"]), rec["checks"]
    assert rec["attempted"] > 0 and rec["failed"] == 0
    reading = C.Reading(cell, rec, spans, None, values, ("cpu", None))
    got = C.per_layer(cell, reading)
    host = {m["name"] for m in cell.per_layer if m["source"] == "host_clock"}
    assert host <= set(got)


def _state_unchanged(trainer):
    trainer.optimizer.step = lambda *a, **k: None


def _half_batch(trainer):
    step = trainer.train_step

    def halved(batch):
        n = len(batch["img_idx"]) // 2
        return step({k: v if k == "cache_images" else v[:n]
                     for k, v in batch.items()})
    trainer.train_step = halved


def _backbone_relu_removed(trainer):
    """The ReLUs of the backbone's units left out, as a conv + BN + ReLU
    fusion that dropped its ReLU would."""
    import torch.nn.functional as F
    from codenet_torch.models import shufflenetv2 as S

    class NoRelu:
        @staticmethod
        def relu(y, *args, **kw):
            return y

        def __getattr__(self, name):
            return getattr(F, name)
    for m in trainer.model.modules():
        if isinstance(m, S.BaseNode):
            def forward(*args, _forward=m.forward, **kw):
                S.F = NoRelu()
                try:
                    return _forward(*args, **kw)
                finally:
                    S.F = F
            m.forward = forward


def _decode_fault(change):
    def plant(detector):
        decode = detector._decode

        def faulty(*args, **kw):
            return change(decode(*args, **kw).clone(), detector)
        detector._decode = faulty
    return plant


def _altered(dets, detector):
    dets[:, 0, 5] = (dets[:, 0, 5] + 1) % detector.num_classes
    return dets


@pytest.mark.parametrize("name,fault", [
    ("tiny_train", _state_unchanged), ("tiny_train", _half_batch),
    ("tiny_train", _backbone_relu_removed),
    ("tiny_serve", _decode_fault(_altered)),
    ("tiny_serve", _decode_fault(lambda d, _: d[:, :d.shape[1] // 2])),
    ("tiny_serve", _decode_fault(lambda d, _: d[:, :1].expand_as(d))),
    ("tiny_serve", _decode_fault(lambda d, _: d[:-1])),
    ("tiny_res_train", _state_unchanged), ("tiny_res_train", _half_batch),
    ("tiny_res_serve", _decode_fault(_altered))],
    ids=["unchanged", "half", "relu_removed", "altered", "half_k",
         "duplicated_peak", "frame_dropped", "res_unchanged", "res_half",
         "res_altered"])
def test_a_fault_in_the_timed_path_is_not_correct(root, name, fault):
    _, rec, _ = run(root, name, [fault])
    assert not compare.passed(rec["checks"]), rec["checks"]


@pytest.mark.parametrize("name", CELLS)
def test_each_fault_of_the_readings_is_not_correct(sound, name):
    """The faults that benchmark.readings plants on the card, planted here
    in the same way, fail the cell's limits: training's half batch and
    the architecture's own, serving's three."""
    cell, rec, _ = sound(name)
    got = (readings.training_readings if cell.workload["kind"] == "train"
           else readings.serving_readings)(cell, rec)
    limits = cell.workload["limits"]
    faults = [f for f in got if f != "control"]
    assert len(faults) == (1 + len(cell.arch.FAULTS)
                           if cell.workload["kind"] == "train" else 3)
    for fault in faults:
        assert any(got[fault][k] > limits[k] for k in limits), (fault, got)


@pytest.mark.parametrize("name", CELLS)
def test_the_control_is_not_correct(sound, name):
    cell, rec, _ = sound(name)
    got = (readings.training_readings if cell.workload["kind"] == "train"
           else readings.serving_readings)(cell, rec)["control"]
    limits = cell.workload["limits"]
    assert any(got[k] > limits[k] for k in limits), (got, limits)


def test_qat_fixture_runs_and_catches_a_dropped_half_batch(root):
    """The W4A8 fine-tune runs through the same harness; rounding flips
    move its sound numbers (PERF.md), yet a dropped half of the batch
    reads far beyond them."""
    _, sound, _ = run(root, "tiny_qat")
    _, fault, _ = run(root, "tiny_qat", [_half_batch])
    assert sound["checks"]["loss_gap"]["value"] < 0.05
    assert fault["checks"]["loss_gap"]["value"] > 0.05


def test_a_mix_fixes_the_host_before_torch_starts():
    """`host_cpus` and `host_threads` of a mix pin the run's process and
    size its pools; a mix without them leaves the process as it was."""
    import subprocess
    import sys
    code = ("import os, sys; from benchmark.run import fix_host; "
            "before = len(os.sched_getaffinity(0)); "
            "assert fix_host({}) is None; "
            "assert len(os.sched_getaffinity(0)) == before; "
            "n = fix_host({'host_cpus': 1, 'host_threads': 1}); "
            "import torch; torch.set_num_threads(n); "
            "print(len(os.sched_getaffinity(0)), "
            "os.environ['OMP_NUM_THREADS'], torch.get_num_threads())")
    out = subprocess.run([sys.executable, "-c", code], cwd=C.ROOT,
                         capture_output=True, text=True, check=True)
    assert out.stdout.split() == ["1", "1", "1"]
