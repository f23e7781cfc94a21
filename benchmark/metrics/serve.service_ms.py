"""serve.service_ms: a request's service, from its submit to its
per-class detections on the host (pre-process, dispatch, the wait for the
card, post-process), mean a request; host clock."""


def read(r):
    s = r.record["services_s"]
    return 1e3 * sum(s) / len(s) if s else None
