"""serve.queue_ms: the time a request waits from falling due to its submit
(for one of the in-flight slots), mean a request; host clock."""


def read(r):
    w = r.record["waits_s"]
    return 1e3 * sum(w) / len(w) if w else None
