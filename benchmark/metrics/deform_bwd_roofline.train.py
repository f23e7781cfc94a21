"""deform_bwd_roofline.train: the co-designed deform backward kernel
(csrc/deform_bwd.cu) against its bound: the least time of the neck's three
backward calls of a step at the cell's batch (benchmark/counts.py: bytes
at HBM bandwidth or CUDA-core flops, the larger) times the steps the trace
holds, over the kernel's device time summed over its calls, in %."""

from benchmark import counts

KERNEL = "codesign_deform_bwd_kernel"


def read(r):
    t = r.trace
    calls = [(n, s) for n, s in t["device_s"].items() if KERNEL in n] \
        if t else []
    if not calls:
        return None
    cfg = r.cell.config
    maps = counts.deform_maps(cfg["input_res"], cfg["w2"])
    n_calls = sum(c for n, c in t["device_calls"].items()
                  if KERNEL in n)
    seconds = sum(s for _, s in calls)
    if not n_calls or seconds <= 0:
        return None
    bound = counts.deform_bwd_bound_s(r.cell.workload["batch"], maps)
    return 100.0 * bound * n_calls / len(maps) / seconds
