"""serve.dispatch_ms: `CtdetDetector.process_batch_raw` until it returns
(the frames' upload, then the device warp, network, flip merge, decode and
back-projection enqueued), mean a request; host clock, the benchmark's
span `dispatch`."""


def read(r):
    return r.spans.mean_ms("dispatch")
