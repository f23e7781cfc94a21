"""train.replay_ms: the host time of the graphed engine's
`graph.replay()` and the copy of the step's stats, mean a step; the
program's span `trainer.replay` in the profiler window
(benchmark/program_spans.py)."""

from benchmark import program_spans


def read(r):
    return program_spans.mean_ms(r.record["trace"], "trainer.replay")
