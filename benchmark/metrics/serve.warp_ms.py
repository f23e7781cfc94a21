"""serve.warp_ms: the device warp inside
`CtdetDetector.process_batch_raw` (`_warped_input`: the affines' upload,
`warp_affine_batch`, the normalisation and the flipped copies), enqueued,
mean a request; the program's span `detector.warp` in the profiler
window (benchmark/program_spans.py)."""

from benchmark import program_spans


def read(r):
    return program_spans.mean_ms(r.record["trace"], "detector.warp")
