"""serve.upload_ms: the raw frames' upload to the card inside
`CtdetDetector.process_batch_raw` (its `_to_device`: 32 zero-padded raw
frames from pageable host memory), mean a request; the program's span
`detector.upload` in the profiler window (benchmark/program_spans.py)."""

from benchmark import program_spans


def read(r):
    return program_spans.mean_ms(r.record["trace"], "detector.upload")
