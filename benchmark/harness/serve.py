"""A serving cell: batch requests of raw host frames offered at a fixed
rate through the program's ctdet detector, flip test, as its batched eval
drives it (`CtdetDetector.pre_process_raw` for each frame on the host,
`process_batch_raw`: upload, device warp, network, decode; the copy back,
then `post_process` and `merge_outputs` for each frame).

Requests fall due on a fixed schedule, `rate_rps` a second (open loop):
one is submitted once it is due and one of `inflight` slots is free, and
a finished one is post-processed as soon as its detections are ready, so
a request is pre-processed and dispatched while the one before it runs on
the card. Every request due in the window is served, late or not; the
window closes when the last one is done. A request's latency runs from
the time it fell due to its per-class detections on the host: the wait
for a slot (`queue`) and its service. After the window a sample of the
finished requests, drawn from the seed, is judged against the reference
(`compare.serving`).
"""

from __future__ import annotations

import collections
import gc
import time

import numpy as np
import torch

from ..reference.serve import dense_detections
from . import compare, probe, traffic, weights
from .train import free, model_args, peak_memory, reset_peak_memory, sync

WARM_REQUESTS = 3
TRACED_REQUESTS = 24
CALIBRATION_FRAMES = 8


def program_opt(cell):
    from codenet_torch import config as C
    cfg, wl = cell.config, cell.workload
    args = model_args(cell) + ["--K", str(wl["K"])]
    if wl["flip_test"]:
        args.append("--flip_test")
    opt = C.parse(args)
    opt = C.update_dataset_info_and_set_heads(
        opt, C.DATASET_SPECS[cfg["dataset"]])
    opt._device_warp_hw = tuple(wl["raw_buffer_hw"])
    return opt


class Server:
    """The program's detector behind `inflight` slots."""

    def __init__(self, detector, pool, dims, spans, inflight, keep, rng):
        self.det = detector
        self.pool = pool
        self.dims = dims
        self.spans = spans
        self.inflight = inflight
        self.queue = collections.deque()
        self.latencies = []
        self.services = []
        self.waits = []
        self.failed = 0
        # a uniform sample of `keep` finished requests (reservoir sampling
        # from `rng`): (frame ids, results), the rest of the results let go
        self.keep, self.rng = keep, rng
        self.sample = []

    def submit(self, ids, due):
        """Pre-process and dispatch request `ids`, due at `due`."""
        t0 = time.perf_counter()
        if self.spans.on:
            self.waits.append(max(t0 - due, 0.0))
        with self.spans.span("pre"):
            raws = [self.det.pre_process_raw(
                self.pool[i, :self.dims[i, 0], :self.dims[i, 1]])
                for i in ids]
            padded = np.stack([r[0] for r in raws])
            warp_tis = np.stack([r[1] for r in raws])
            trans_invs = np.stack([r[2] for r in raws])
        with self.spans.span("dispatch"):
            dev = self.det.process_batch_raw(padded, warp_tis, trans_invs)
            ready = None
            if dev.is_cuda:
                ready = torch.cuda.Event()
                ready.record()
        self.queue.append((ids, due, t0, dev, ready))

    def oldest_ready(self):
        return bool(self.queue) and (self.queue[0][4] is None
                                     or self.queue[0][4].query())

    def drain_one(self):
        ids, due, t0, dev, _ = self.queue.popleft()
        with self.spans.span("wait"):
            dets = dev.cpu().numpy()
        with self.spans.span("post"):
            # a frame that the program answered with no row gets none
            results = [self.det.merge_outputs(
                [self.det.post_process(dets[i] if i < len(dets)
                                       else dets[:0], None)])
                for i in range(len(ids))]
        done = time.perf_counter()
        self.latencies.append(done - due)
        self.services.append(done - t0)
        self.failed += not all(np.isfinite(v).all() for r in results
                               for v in r.values())
        n = len(self.latencies)
        if n <= self.keep:
            self.sample.append((ids, results))
        else:
            j = self.rng.randint(n)
            if j < self.keep:
                self.sample[j] = (ids, results)

    def drain(self):
        while self.queue:
            self.drain_one()

    def offer(self, t0, seconds, rate, request, step):
        """Serve every request due at t0 + n / rate before t0 + seconds;
        `step` is called after each submit. Returns the count."""
        n = 0
        while t0 + n / rate < t0 + seconds:
            due = t0 + n / rate
            now = time.perf_counter()
            if len(self.queue) >= self.inflight:
                self.drain_one()
            elif now >= due:
                self.submit(request(n), due)
                step()
                n += 1
            elif self.oldest_ready():
                self.drain_one()
            else:
                time.sleep(min(due - now, 2e-4))
        self.drain()
        return n

    def reset(self):
        self.latencies, self.services, self.waits = [], [], []
        self.failed, self.sample = 0, []


def _served_tensor(results):
    """A frame's {class: (n, 5)} results as (M, 6) [box score class-1]."""
    rows = [np.concatenate([r, np.full((len(r), 1), j - 1, np.float32)], 1)
            for j, r in sorted(results.items()) if len(r)]
    if not rows:
        return torch.zeros((0, 6))
    return torch.as_tensor(np.concatenate(rows))


def run(cell, seed, seconds, spans, traced, device, faults=()):
    from codenet_torch.engine.detector import CtdetDetector

    cfg, wl = cell.config, cell.workload
    data_seed, weight_seed, order_seed = traffic.seeds(seed, 3)
    rng = np.random.RandomState(data_seed)
    dims = traffic.frame_sizes(wl["frames"], rng)
    pool = traffic.host_pool(dims, data_seed, device)
    params, buffers = weights.make(cell.arch, cfg, weight_seed, device)
    calib = torch.as_tensor(pool[:CALIBRATION_FRAMES], device=device)
    buffers = weights.calibrated(cell.arch, cfg, params, buffers, calib,
                                 dims[:CALIBRATION_FRAMES])
    del calib
    reset_peak_memory(device)
    opt = program_opt(cell)
    detector = CtdetDetector(opt, state_dict=weights.state_dict(
        params, buffers), device=device)
    for fault in faults:
        fault(detector)
    order = np.random.RandomState(order_seed).permutation(len(dims))
    b = wl["batch"]

    def request(n):
        return [int(order[(n * b + j) % len(order)]) for j in range(b)]

    server = Server(detector, pool, dims, spans, wl["inflight"],
                    wl["sample_requests"],
                    np.random.RandomState(order_seed ^ 0x5EED))
    for n in range(WARM_REQUESTS):
        server.submit(request(n), time.perf_counter())
        server.drain()
    sync(device)
    server.reset()
    gc.collect()

    window = probe.Window(traced, TRACED_REQUESTS)
    window.prepare(device)
    spans.on = True
    with window:
        t0, wall0 = time.perf_counter(), time.time()
        n = server.offer(t0, seconds, wl["rate_rps"],
                         lambda k: request(WARM_REQUESTS + k), window.step)
        sync(device)
        t1 = time.perf_counter()
    spans.on = False
    done = len(server.latencies)
    record = {
        "window_s": t1 - t0, "requests": done, "images": done * b,
        "attempted": n, "failed": server.failed + (n - done),
        "latencies_s": sorted(server.latencies),
        "services_s": server.services, "waits_s": server.waits,
        "memory_peak_bytes": peak_memory(device),
        "trace": window.events(), "window_start_wall": wall0}

    sample = server.sample
    del detector, server
    free(device)
    frames, served = [], []
    for ids, results in sample:
        for i, res in zip(ids, results):
            frames.append(pool[i, :dims[i, 0], :dims[i, 1]])
            served.append(_served_tensor(res))
    record["checks"] = judge(cell, frames, served, params, buffers,
                             wl["limits"])
    record["inputs"] = (params, buffers, frames, served)
    return record


def judge(cell, frames, served, params, buffers, limits, chunk=32):
    """compare.serving of served detections against the reference, the
    frames in chunks of `chunk` (None when no request finished)."""
    worst = None
    k = cell.workload["K"]
    for lo in range(0, len(frames), chunk):
        dense = dense_detections(cell.arch, frames[lo:lo + chunk],
                                 cell.config, params, buffers, k)
        got = compare.serving(served[lo:lo + chunk], dense, limits, k)
        worst = got if worst is None else {
            n: compare.check(max(worst[n]["value"], v["value"]), v["limit"])
            for n, v in got.items()}
        del dense
    return worst
