"""serve.decode_ms: the decode inside
`CtdetDetector.process_batch_raw` (the back-projections' upload, top-K
decode and back-projection), enqueued, mean a request; the program's span
`detector.decode` in the profiler window (benchmark/program_spans.py)."""

from benchmark import program_spans


def read(r):
    return program_spans.mean_ms(r.record["trace"], "detector.decode")
