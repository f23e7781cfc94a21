"""Evaluation CLI (reference test.py).

Runs the detector over the validation split with thread-prefetched
pre-processing (reference PrefetchDataset, test.py:23-46), aggregates
per-stage timers, and calls the dataset's in-process evaluator.

    python -m codenet_torch.cli.test ctdet --dataset pascal \\
        --arch shufflenetv2 --input_res 256 --flip_test [--gpus -1]

``--gpus -1`` runs on the CPU; otherwise the CUDA card is required.
"""

from __future__ import annotations

import os
import queue
import threading
import time
from collections import deque
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from .. import config as cfg
from ..data.datasets import get_dataset
from ..engine.detector import detector_factory
from ..utils.meters import AverageMeter

_TIMERS = ["tot", "load", "pre", "net", "dec", "post", "merge"]


def _setup(opt):
    Dataset = get_dataset(opt.dataset, opt.task)
    opt = cfg.update_dataset_info_and_set_heads(
        opt, cfg.DATASET_SPECS[opt.dataset])
    print(opt.heads)
    split = "val" if not opt.trainval else "test"
    return opt, Dataset(opt, split)


def _log(ind, num_iters, avg_time_stats):
    if ind % 100 == 0:
        print("[{}/{}] ".format(ind, num_iters)
              + "".join("|{} {:.3f} ".format(t_, avg_time_stats[t_].avg)
                        for t_ in avg_time_stats))


def _prefetch(dataset, detector, opt, q):
    try:
        for ind in range(len(dataset)):
            img_id = dataset.images[ind]
            image = dataset.load_image(ind)
            images, meta = {}, {}
            for scale in opt.test_scales:
                images[scale], meta[scale] = detector.pre_process(image,
                                                                  scale)
            q.put((img_id, {"images": images, "image": image, "meta": meta}))
    except Exception as e:  # handed to the consumer, which re-raises
        q.put(e)
    finally:
        q.put(None)


def prefetch_test(opt):
    opt, dataset = _setup(opt)
    detector = detector_factory(opt.task)(opt)

    q = queue.Queue(maxsize=4)
    t = threading.Thread(target=_prefetch,
                         args=(dataset, detector, opt, q), daemon=True)
    t.start()

    results = {}
    avg_time_stats = {t_: AverageMeter() for t_ in _TIMERS}
    ind = 0
    while True:
        item = q.get()
        if item is None:
            break
        if isinstance(item, Exception):
            raise item
        img_id, pre_processed = item
        ret = detector.run(pre_processed)
        results[img_id] = ret["results"]
        for t_ in avg_time_stats:
            avg_time_stats[t_].update(ret[t_])
        _log(ind, len(dataset), avg_time_stats)
        ind += 1
    t.join()
    os.makedirs(opt.save_dir, exist_ok=True)
    return dataset.run_eval(results, opt.save_dir)


def test(opt):
    """Serial (non-prefetched) eval path (reference test.py:85-125)."""
    opt, dataset = _setup(opt)
    detector = detector_factory(opt.task)(opt)

    results = {}
    avg_time_stats = {t_: AverageMeter() for t_ in _TIMERS}
    for ind in range(len(dataset)):
        img_id = dataset.images[ind]
        ret = detector.run(dataset.load_image(ind))
        results[img_id] = ret["results"]
        for t_ in avg_time_stats:
            avg_time_stats[t_].update(ret[t_])
        _log(ind, len(dataset), avg_time_stats)
    os.makedirs(opt.save_dir, exist_ok=True)
    return dataset.run_eval(results, opt.save_dir)


def batched_test(opt):
    """Batched single-scale eval (--batch_eval N, an extension): a thread
    pool reads and pre-processes images, fixed-size batches run one
    forward + decode + back-projection, and only class bucketing happens
    per image on the host. The reference evaluates image by image."""
    if opt.device_warp or opt.device_cache:
        raise NotImplementedError(
            "--device_warp / --device_cache are queued in ROADMAP.md")
    opt, dataset = _setup(opt)
    detector = detector_factory(opt.task)(opt)
    bs = opt.batch_eval

    stage = {"disk": 0.0, "warp": 0.0, "stall": 0.0, "dispatch": 0.0,
             "post": 0.0}
    stage_lock = threading.Lock()  # load_one runs on worker threads

    def load_one(ind):
        img_id = dataset.images[ind]
        t0 = time.time()
        image = dataset.load_image(ind)
        t1 = time.time()
        images, meta = detector.pre_process(image, 1.0)
        with stage_lock:
            stage["disk"] += t1 - t0
            stage["warp"] += time.time() - t1
        return img_id, images, meta

    results = {}
    n = len(dataset)
    workers = max(1, opt.num_workers)
    inflight = deque()

    def drain(force=False):
        # one batch stays in flight while the next one is pre-processed
        while inflight and (force or len(inflight) > 1):
            ids, dev = inflight.popleft()
            t0 = time.time()
            dets = dev.cpu().numpy()  # device sync point
            t1 = time.time()
            stage["dispatch"] += t1 - t0
            for i, img_id in enumerate(ids):
                per = detector.post_process(dets[i], None)
                results[img_id] = detector.merge_outputs([per])
            stage["post"] += time.time() - t1

    def run_chunk(chunk):
        ids = [c[0] for c in chunk]
        # pad to the fixed batch size with the last sample
        padded = chunk + [chunk[-1]] * (bs - len(chunk))
        per_img = [c[1] for c in padded]  # each (1 or 2, H, W, 3)
        if opt.flip_test:
            stack = np.concatenate(
                [p[0:1] for p in per_img] + [p[1:2] for p in per_img],
                axis=0)
        else:
            stack = np.concatenate(per_img, axis=0)
        tis = np.stack([c[2]["trans_inv"] for c in padded], axis=0)
        inflight.append((ids, detector.process_batch(stack, tis)))
        drain()

    t_start = time.time()
    with ThreadPoolExecutor(max_workers=workers) as pool:
        # bounded window of outstanding loads (backpressure)
        window = workers + 2 * bs
        pending = deque(pool.submit(load_one, i)
                        for i in range(min(window, n)))
        nxt = len(pending)
        chunk, done = [], 0
        while pending:
            t0 = time.time()
            item = pending.popleft().result()
            stage["stall"] += time.time() - t0
            if nxt < n:
                pending.append(pool.submit(load_one, nxt))
                nxt += 1
            chunk.append(item)
            if len(chunk) == bs:
                run_chunk(chunk)
                done += bs
                chunk = []
                if done % (bs * 10) == 0:
                    print("[{}/{}] {:.1f} img/s".format(
                        done, n, done / (time.time() - t_start)))
        if chunk:
            run_chunk(chunk)
            done += len(chunk)
        drain(force=True)
    print("batched eval: {} images in {:.1f}s".format(
        done, time.time() - t_start))
    print("  stages (s): disk {disk:.2f} warp {warp:.2f} (thread-sum) | "
          "stall {stall:.2f} devsync {dispatch:.2f} post {post:.2f} "
          "(critical path)".format(**stage), flush=True)
    os.makedirs(opt.save_dir, exist_ok=True)
    return dataset.run_eval(results, opt.save_dir)


def main(argv=None):
    opt = cfg.parse(argv)
    if opt.batch_eval > 1:
        return batched_test(opt)
    if opt.not_prefetch_test:
        return test(opt)
    return prefetch_test(opt)


if __name__ == "__main__":
    main()
