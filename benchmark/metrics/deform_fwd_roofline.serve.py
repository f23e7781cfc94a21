"""deform_fwd_roofline.serve: the co-designed deform forward kernel
(csrc/deform_fwd.cu) against its bound: the least time of the neck's three
forward calls of a request's forward (the batch and its flipped copy;
benchmark/counts.py) times the forwards the trace holds, over the
kernel's device time summed over its calls, in %."""

from benchmark import counts

KERNEL = "codesign_deform_fwd_kernel"


def read(r):
    t = r.trace
    calls = [(n, s) for n, s in t["device_s"].items() if KERNEL in n] \
        if t else []
    if not calls:
        return None
    cfg, wl = r.cell.config, r.cell.workload
    maps = counts.deform_maps(cfg["input_res"], cfg["w2"])
    n_calls = sum(c for n, c in t["device_calls"].items()
                  if KERNEL in n)
    seconds = sum(s for _, s in calls)
    if not n_calls or seconds <= 0:
        return None
    images = wl["batch"] * (2 if wl.get("flip_test") else 1)
    bound = counts.deform_fwd_bound_s(images, maps)
    return 100.0 * bound * n_calls / len(maps) / seconds
