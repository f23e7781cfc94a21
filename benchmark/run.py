"""Run one cell of the benchmark once and print its result line.

    python3 -m benchmark.run --workload <name> --seed <n> --seconds <s> \\
        --trace <0|1>

from the root of a checkout, on a machine with the CUDA cards the cell
asks for. It makes the cell's frames and weights from --seed, warms the
program up, measures for --seconds, judges what the timed path produced
against the plain reference (benchmark/reference/), and prints the cell's
end-to-end metrics (--trace 0) or its per-layer metrics from a profiler
window (--trace 1) as the last line of standard output, one JSON object,
with each compared number beside its limit (also the last lines of
standard error). Without the cards it exits 2 and prints no result.
"""

from __future__ import annotations

import os
import sys
import time


def _process_start():
    """The wall time at which this process started (Linux /proc), or
    now."""
    try:
        with open("/proc/self/stat") as f:
            ticks = float(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/stat") as f:
            boot = next(float(line.split()[1]) for line in f
                        if line.startswith("btime"))
        return boot + ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError, StopIteration):
        return time.time()


PROCESS_START = _process_start()
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CACHE = os.path.join(ROOT, "benchmark", "_cache")
# every compiler cache at a fixed path inside the checkout; the program's
# own kernels build into codenet_torch/_build/
for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("TRITON_CACHE_DIR", "triton"),
                 ("CUDA_CACHE_PATH", "nv_compute")):
    os.environ[var] = os.path.join(CACHE, sub)
os.environ["USE_FLAX"] = "0"

FORBIDDEN = ("jax", "jaxlib", "flax", "codenet_tpu", "tools_tpu")


def parse(argv):
    import argparse
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def forbidden_modules():
    return sorted(k for k in sys.modules if k.split(".")[0] in FORBIDDEN)


def card():
    """(name, power limit in W or None) of card 0."""
    import subprocess
    import torch
    name = torch.cuda.get_device_name(0)
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits", "-i", "0"],
            capture_output=True, text=True, timeout=20).stdout.strip()
        return name, float(out.splitlines()[0])
    except (OSError, ValueError, IndexError, subprocess.SubprocessError):
        return name, None


def fix_host(mix):
    """The process's CPUs and thread pools, where the cell's mix fixes
    them, before torch starts a thread: `host_cpus` pins the process to
    that many of the CPUs it may use (the lowest), `host_threads` sizes
    torch's and OpenMP's pools. Returns the pools' size or None."""
    cpus = mix.get("host_cpus")
    if cpus and hasattr(os, "sched_setaffinity"):
        os.sched_setaffinity(0, sorted(os.sched_getaffinity(0))[:cpus])
    threads = mix.get("host_threads")
    if threads:
        for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS"):
            os.environ[var] = str(threads)
    return threads


def main(argv=None):
    args = parse(sys.argv[1:] if argv is None else argv)
    from benchmark.harness import cell as C
    cell = C.Cell(args.workload)
    threads = fix_host(cell.workload)
    import torch

    from benchmark.harness import compare, probe
    if threads:
        torch.set_num_threads(threads)
    if not torch.cuda.is_available() \
            or torch.cuda.device_count() < cell.chips:
        print("benchmark: the cell needs {} CUDA card(s); {} visible".format(
            cell.chips, torch.cuda.device_count()
            if torch.cuda.is_available() else 0), file=sys.stderr)
        return 2
    # the configurations state float32 with TF32 off
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    traced = bool(args.trace)
    spans = probe.Spans(traced)
    record = C.run(cell, args.seed, args.seconds, traced, "cuda:0", spans)
    setup_s = record["window_start_wall"] - PROCESS_START
    values = C.end_to_end(cell, record, setup_s)
    name, limit_w = card()
    device = {"platform": "gpu", "kind": name, "count": cell.chips,
              "memory_peak_bytes": record["memory_peak_bytes"],
              "power_limit_w": limit_w}
    result = {"correct": False, "attempted": record["attempted"],
              "failed": record["failed"]}
    if traced:
        trace = probe.summarise(record["trace"]) if record["trace"] else None
        if trace is None or trace["busy_s"] <= 0:
            print("benchmark: the traced window holds no device operation",
                  file=sys.stderr)
            return 3
        reading = C.Reading(cell, record, spans, trace, values,
                            (name, limit_w))
        result["metrics"] = C.per_layer(cell, reading)
        device.update(busy_s=trace["busy_s"], window_s=trace["window_s"])
        result["device"] = device
        result["breakdown"] = {"device_ops": trace["device_ops"],
                               "idle_gaps": trace["idle_gaps"]}
    else:
        units = {m["name"]: m["unit"] for m in cell.end_to_end}
        result["metrics"] = {k: {"value": v, "unit": units[k]}
                             for k, v in values.items()}
        result["device"] = device
    checks = record["checks"] or {}
    result["correct"] = compare.passed(checks)
    result["checks"] = checks
    bad = forbidden_modules()
    if bad:
        print("benchmark: loaded {}".format(", ".join(bad)), file=sys.stderr)
        return 4
    for k, c in checks.items():
        print("check {} {!r} limit {!r} {}".format(
            k, c["value"], c["limit"],
            "ok" if c["value"] <= c["limit"] else "FAILED"), file=sys.stderr)
    sys.stderr.flush()
    import json
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
