"""serve.pre_ms: the host pre-process of a request
(`CtdetDetector.pre_process_raw` of each of its frames: geometry and the
zero-padded raw buffer, then the batch stacked), mean a request; host
clock, the benchmark's span `pre`."""


def read(r):
    return r.spans.mean_ms("pre")
