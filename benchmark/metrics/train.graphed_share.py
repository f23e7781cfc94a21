"""train.graphed_share: the steps the graphed engine took as a replay of
its graph, over every step it took (a replay, an eager step outside a
graph, a capture), in %; the program's spans `trainer.replay`,
`trainer.eager` and `trainer.capture` counted in the profiler window
(benchmark/program_spans.py)."""

from benchmark import program_spans

PARTS = ("trainer.replay", "trainer.eager", "trainer.capture")


def read(r):
    return program_spans.share(r.record["trace"], "trainer.replay", PARTS)
