"""Batched, prefetching data loader (the JAX package's data/loader.py).

A pool of `num_workers` threads maps the numpy sampler, stacks samples
into fixed-shape numpy dicts and prefetches ahead of the device. Batch
order is the same at any worker count: workers take batch numbers from a
queue and publish into per-batch slots that the consumer drains in order.
Each batch draws from its own np.random.RandomState seeded with
SeedSequence((seed, epoch, batch)), the JAX loader's stream, so the same
seed gives the same batches in both packages.

Data parallelism: every rank builds the same global batches (the same
shuffle stream, the same per-batch streams) and keeps rows [lo, hi) of
each (`rows`, parallel/multihost.py::process_batch_slice), bit-equal to
those rows of the single-process batch. A batch's samples draw one after
another from its one stream, so a rank first replays the draws of the
rows before lo, in rank order, without building them: the sampler's
``get_sample(..., draw_only=True)`` makes the random draws of a sample
(crop, scale, flip, rotation, colour state), which need the frame's
dimensions only, and skips its image read, warp and targets. Rows after
hi are never drawn.

Sharded-cache routing (`shard_ranges`, --device_cache_shard): the JAX
loader's. Batch slot-block s (the rows rank s holds) is drawn only from
shard s's dataset rows, so a rank's cache holds every row its batches
ask for. Each shard shuffles within itself, every batch takes batch/d
rows of each, and an epoch stops at the smallest shard.
"""

from __future__ import annotations

import queue
import threading

import numpy as np


def _stack_samples(samples):
    """Stack a list of sample dicts into one batch dict (meta as a list)."""
    out = {}
    for k in samples[0]:
        if k == "meta":
            out["meta"] = [s["meta"] for s in samples]
        else:
            out[k] = np.stack([s[k] for s in samples], axis=0)
    return out


def batch_rng(seed, epoch, b):
    """The per-batch stream of batch `b` in `epoch`."""
    return np.random.RandomState(np.random.SeedSequence(
        (seed & 0xFFFFFFFF, epoch, b)).generate_state(1)[0])


class DataLoader:
    def __init__(self, dataset, batch_size, shuffle=False, num_workers=4,
                 drop_last=None, seed=0, prefetch=3, shard_ranges=None,
                 rows=None):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.num_workers = max(1, num_workers)
        # static shapes: drop the ragged last batch when training
        self.drop_last = shuffle if drop_last is None else drop_last
        self.seed = seed
        self.rng = np.random.RandomState(seed)
        self.prefetch = prefetch
        self._epoch = 0
        # (lo, hi): the rows of each batch this process keeps
        self.rows = rows
        self.shard_ranges = shard_ranges
        if shard_ranges is not None:
            if batch_size % len(shard_ranges):
                raise ValueError(
                    "batch_size {} not divisible by {} cache shards"
                    .format(batch_size, len(shard_ranges)))
            bl = batch_size // len(shard_ranges)
            if min(hi - lo for lo, hi in shard_ranges) < bl:
                raise ValueError(
                    "a cache shard holds fewer images than its per-batch "
                    "slice ({}); use fewer devices or a smaller batch"
                    .format(bl))

    def __len__(self):
        if self.shard_ranges is not None:
            bl = self.batch_size // len(self.shard_ranges)
            return min(hi - lo for lo, hi in self.shard_ranges) // bl
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def _batches(self):
        """This epoch's batches of dataset indices (advances the shuffle
        stream, as iterating does)."""
        if self.shard_ranges is not None:
            return self._shard_batches()
        order = np.arange(len(self.dataset))
        if self.shuffle:
            self.rng.shuffle(order)
        batches = []
        for i in range(0, len(order), self.batch_size):
            idx = order[i:i + self.batch_size]
            if len(idx) < self.batch_size and self.drop_last:
                continue
            batches.append(idx)
        return batches

    def _shard_batches(self):
        """Per-shard orders -> slot-block-routed batches (the JAX
        loader's)."""
        orders = [np.arange(lo, hi) for lo, hi in self.shard_ranges]
        if self.shuffle:
            for o in orders:
                self.rng.shuffle(o)
        bl = self.batch_size // len(orders)
        m = min(len(o) for o in orders) // bl
        return [np.concatenate([o[k * bl:(k + 1) * bl] for o in orders])
                for k in range(m)]

    def _samples(self, idx, brng):
        """The samples of this process's rows of batch `idx`."""
        lo, hi = self.rows or (0, len(idx))
        for j in idx[:lo]:
            self.dataset.get_sample(j, rng=brng, draw_only=True)
        return [self.dataset.get_sample(j, rng=brng) for j in idx[lo:hi]]

    def __iter__(self):
        batches = self._batches()
        n_workers = min(self.num_workers, max(1, len(batches)))
        # at most prefetch + n_workers batches in flight: ordered delivery
        # buffers every earlier batch, so this bounds memory
        todo = queue.Queue()
        done = {}  # batch number -> batch dict | Exception
        done_cv = threading.Condition()
        stop = threading.Event()
        max_inflight = self.prefetch + n_workers
        for b in range(min(max_inflight, len(batches))):
            todo.put(b)
        next_admit = min(max_inflight, len(batches))
        epoch = self._epoch
        self._epoch += 1

        def worker():
            while not stop.is_set():
                try:
                    b = todo.get(timeout=0.1)
                except queue.Empty:
                    continue
                if b is None:
                    break
                try:
                    result = _stack_samples(self._samples(
                        batches[b], batch_rng(self.seed, epoch, b)))
                except Exception as e:  # handed to the consumer
                    result = e
                with done_cv:
                    done[b] = result
                    done_cv.notify_all()

        threads = [threading.Thread(target=worker, daemon=True)
                   for _ in range(n_workers)]
        for t in threads:
            t.start()
        try:
            for b in range(len(batches)):
                with done_cv:
                    while b not in done:
                        done_cv.wait(timeout=1.0)
                    item = done.pop(b)
                if isinstance(item, Exception):
                    raise item
                if next_admit < len(batches):
                    todo.put(next_admit)
                    next_admit += 1
                yield item
        finally:
            stop.set()
            for _ in threads:
                todo.put(None)
