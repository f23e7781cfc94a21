"""serve.net_ms: the served forward inside
`CtdetDetector.process_batch_raw` (`_heads`: the eager forward of the
batch and its flipped copy, the sigmoid and the flip merge) until it is
enqueued, mean a request; the program's span `detector.net` in the
profiler window (benchmark/program_spans.py)."""

from benchmark import program_spans


def read(r):
    return program_spans.mean_ms(r.record["trace"], "detector.net")
