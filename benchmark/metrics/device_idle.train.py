"""device_idle.train: the share of the traced window of a training cell in
which no operation ran on the card: 1 - (union of device intervals) /
(window), in %; the profiler's trace."""


def read(r):
    t = r.trace
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"]) if t else None
