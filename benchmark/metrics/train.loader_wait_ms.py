"""train.loader_wait_ms: the host time the engine waits in next() on the
loader the benchmark hands to `Trainer.run_epoch` (data/loader.py,
data/samplers.py), mean a step of the window; host clock, the benchmark's
span `loader_wait`."""


def read(r):
    return r.spans.mean_ms("loader_wait")
