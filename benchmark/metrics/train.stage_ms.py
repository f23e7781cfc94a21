"""train.stage_ms: the graphed engine's copy of a batch into the step's
inputs (`make_multi_train_step`'s `load`: pinning and the non-blocking
copies enqueued; `batch_to_device` on the per-step path), mean a step;
the program's span `trainer.stage` in the profiler window
(benchmark/program_spans.py)."""

from benchmark import program_spans


def read(r):
    return program_spans.mean_ms(r.record["trace"], "trainer.stage")
