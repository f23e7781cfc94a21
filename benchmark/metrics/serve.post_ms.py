"""serve.post_ms: the host post-process of a request after its copy back
(`CtdetDetector.post_process` and `merge_outputs` of each frame), mean a
request; host clock, the benchmark's span `post`."""


def read(r):
    return r.spans.mean_ms("post")
