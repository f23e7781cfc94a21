"""benchmark/program_spans.py and the readers of the program's spans on
hand-made (device, host) events: the mean a step, spans outside the
profiler-step window left out, a missing span or an untraced run read as
None, and train.graphed_share with an eager step and a capture inside the
window."""

import types

import pytest

from benchmark import program_spans as PS
from benchmark.harness import cell as C

MS = 1_000_000  # ns


def steps(n, start=10 * MS, every=70 * MS):
    """n ProfilerStep annotations, `every` ns apart from `start`."""
    return [("ProfilerStep#{}".format(6 + i), start + i * every,
             start + (i + 1) * every) for i in range(n)]


def span(name, start_ms, dur_ms):
    return ("codenet." + name, int(start_ms * MS),
            int((start_ms + dur_ms) * MS))


def reading(host, cell="d_serve_flip_b32"):
    record = {"trace": ([("kernel", 10 * MS, 11 * MS)], host)}
    return types.SimpleNamespace(cell=C.Cell(cell), record=record)


def read(metric, host, cell="d_serve_flip_b32"):
    return C.Cell(cell).reader(metric)(reading(host, cell))


def test_mean_a_step_counts_spans_starting_in_the_window():
    # two steps over [10, 150] ms; one upload before and one after them
    host = steps(2) + [span("detector.upload", 12, 4.0),
                       span("detector.upload", 82, 5.0),
                       span("detector.upload", 5, 3.0),
                       span("detector.upload", 151, 9.0),
                       ("bench.dispatch", 11 * MS, 60 * MS)]
    assert PS.mean_ms((None, host), "detector.upload") == pytest.approx(4.5)
    assert PS.count((None, host), "detector.upload") == 2
    assert read("serve.upload_ms", host) == pytest.approx(4.5)


@pytest.mark.parametrize("metric,name", [
    ("serve.upload_ms", "detector.upload"),
    ("serve.warp_ms", "detector.warp"),
    ("serve.net_ms", "detector.net"),
    ("serve.decode_ms", "detector.decode"),
    ("train.stage_ms", "trainer.stage"),
    ("train.replay_ms", "trainer.replay")])
def test_each_time_reader_reads_its_span(metric, name):
    cell = "d_train_fp32_b32" if metric.startswith("train") \
        else "d_serve_flip_b32"
    others = [span("detector.dispatch", 11, 50), span("trainer.step", 11, 50)]
    host = steps(4) + others + [span(name, 11 + 70 * i, 0.25 * (i + 1))
                                for i in range(4)]
    assert read(metric, host, cell) == pytest.approx(2.5 / 4)
    # the parent program, which has no such span, and an untraced run
    assert read(metric, steps(4) + others, cell) is None
    r = reading(host, cell)
    r.record["trace"] = None
    assert C.Cell(cell).reader(metric)(r) is None


def test_no_profiler_step_reads_none():
    host = [span("detector.net", 1, 40)]
    assert PS.mean_ms((None, host), "detector.net") is None
    assert PS.count((None, host), "detector.net") is None
    assert read("serve.net_ms", host) is None


def test_graphed_share_counts_eager_steps_and_captures_in_the_window():
    cell = "d_train_fp32_b32"
    replays = [span("trainer.replay", 12 + 70 * i, 1) for i in range(8)]
    assert read("train.graphed_share", steps(8) + replays, cell) == 100.0
    # a step off the graph and a graph built again inside the window, and
    # an eager warm-up before it, which does not count
    host = steps(8) + replays[:6] + [span("trainer.eager", 432, 60),
                                     span("trainer.capture", 502, 60),
                                     span("trainer.replay", 565, 1),
                                     span("trainer.eager", 2, 3)]
    assert read("train.graphed_share", host, cell) == pytest.approx(
        100.0 * 7 / 9)
    assert read("train.graphed_share", steps(8), cell) is None


def test_the_readers_are_listed_for_their_cells():
    for name, metrics in (("d_serve_flip_b32", {
            "serve.upload_ms", "serve.warp_ms", "serve.net_ms",
            "serve.decode_ms"}), ("d_train_fp32_b32", {
                "train.stage_ms", "train.replay_ms",
                "train.graphed_share"})):
        cell = C.Cell(name)
        listed = {m["name"]: m for m in cell.per_layer}
        assert metrics <= set(listed)
        assert {listed[m]["source"] for m in metrics} == {"device_trace"}
