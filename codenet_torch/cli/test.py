"""Evaluation CLI (reference test.py).

Runs the detector over the validation split with thread-prefetched
pre-processing (reference PrefetchDataset, test.py:23-46), aggregates
per-stage timers, and calls the dataset's in-process evaluator.

    python -m codenet_torch.cli.test ctdet --dataset pascal \\
        --arch shufflenetv2 --input_res 256 --flip_test [--gpus -1]
    python -m codenet_torch.cli.test multi_pose --dataset coco_hp \\
        --arch shufflenetv2 --flip_test [--gpus -1]
    python -m codenet_torch.cli.test ddd --dataset kitti \\
        --arch shufflenetv2 [--gpus -1]
    python -m codenet_torch.cli.test exdet --dataset coco \\
        --arch shufflenetv2 --flip_test [--gpus -1]

``--gpus -1`` runs on the CPU; otherwise the CUDA card is required.
``--test_scales`` with several scales or ``--nms`` merges with soft-NMS;
``--keep_res`` evaluates at each frame's own size. ``--batch_eval N``
batches single-scale fix_res ctdet eval, its letterbox warp on the host,
on the device (``--device_warp``) or from a device-resident copy of the
split (``--device_cache``).
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


def _request_meta(dataset, opt, ind):
    """The request's meta: ddd's per-image calibration, when the image
    carries one (reference test.py:38-40 and :118-121), else None."""
    if opt.task != "ddd":
        return None
    info = dataset.coco.loadImgs(ids=[dataset.images[ind]])[0]
    if "calib" not in info:
        return None
    return {"calib": np.array(info["calib"], dtype=np.float32)}


def _prefetch(dataset, detector, opt, q):
    try:
        for ind in range(len(dataset)):
            img_id = dataset.images[ind]
            image = dataset.load_image(ind)
            in_meta = _request_meta(dataset, opt, ind)
            images, meta = {}, {}
            for scale in opt.test_scales:
                images[scale], meta[scale] = detector.pre_process(
                    image, scale, in_meta)
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
        ret = detector.run(dataset.load_image(ind),
                           _request_meta(dataset, opt, ind))
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
    per image on the host. The reference evaluates image by image.

    The letterbox warp runs on the host, or on the device: --device_warp
    copies each raw frame, zero-padded into a fixed buffer, and warps it
    there (a frame larger than the buffer takes the host warp);
    --device_cache copies the whole split to the device once, then sends
    only row indices and affines, K batches per call. Tasks other than
    ctdet, several test scales or --keep_res fall back to the per-image
    eval."""
    if (opt.task != "ctdet" or len(opt.test_scales) != 1
            or opt.test_scales[0] != 1 or not opt.fix_res):
        print("batch_eval: unsupported config (needs ctdet, single scale, "
              "fixed res); falling back to per-image eval")
        return prefetch_test(opt)
    opt, dataset = _setup(opt)
    if opt.device_warp and not getattr(opt, "_device_warp_hw", None):
        # a tight raw buffer from the dataset's metadata: every padded
        # byte is copied to the card, and VOC's 500x375 frames fill a
        # 512x512 buffer where the square --device_warp_max_res (768)
        # would copy 2.25x as much
        infos = dataset.coco.loadImgs(ids=list(dataset.images))
        cap = opt.device_warp_max_res

        def _round(v):
            return min(-(-v // 64) * 64, cap)

        opt._device_warp_hw = (_round(max(i["height"] for i in infos)),
                               _round(max(i["width"] for i in infos)))
    detector = detector_factory(opt.task)(opt)
    bs = opt.batch_eval

    cache_dev = cache_geo = None
    if opt.device_cache:
        from ..data.device_cache import ImageCache
        if opt.device_cache_shard:
            # eval runs in one process; its cache is always whole
            print("note: --device_cache_shard shards the TRAIN cache "
                  "only; the eval cache is replicated")
        t0 = time.time()
        eval_cache = ImageCache.build(dataset)
        cache_dev = eval_cache.to_device(detector.device)
        cache_geo = [detector.pre_process_geometry(int(h), int(w))
                     for h, w in eval_cache.dims]
        print("device_cache: {} images, {:.1f} MB -> {} in {:.1f}s".format(
            len(dataset), eval_cache.nbytes / 1e6, detector.device,
            time.time() - t0))

    stage = {"disk": 0.0, "warp": 0.0, "stall": 0.0, "dispatch": 0.0,
             "post": 0.0}
    stage_lock = threading.Lock()  # load_one runs on worker threads
    host_fallbacks = []

    def load_one(ind):
        img_id = dataset.images[ind]
        if cache_dev is not None:
            # the pixels stay on the device: only the row and affines
            return ("cached", img_id, ind) + cache_geo[ind]
        t0 = time.time()
        image = dataset.load_image(ind)
        t1 = time.time()
        item = None
        if opt.device_warp:
            raw = detector.pre_process_raw(image)
            if raw is not None:
                item = ("raw", img_id) + raw
            else:
                with stage_lock:
                    host_fallbacks.append(img_id)
        if item is None:
            images, meta = detector.pre_process(image, 1.0)
            item = ("host", img_id, images, meta["trans_inv"])
        with stage_lock:
            stage["disk"] += t1 - t0
            stage["warp"] += time.time() - t1
        return item

    results = {}
    n = len(dataset)
    workers = max(1, opt.num_workers)
    inflight = deque()

    def drain(force=False):
        # one call stays in flight while the next one is pre-processed
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

    def fields(chunk, *cols):
        """Per column, the chunk's values stacked, padded to the fixed
        batch size with the last item."""
        padded = chunk + [chunk[-1]] * (bs - len(chunk))
        return [np.stack([c[k] for c in padded]) for k in cols]

    def run_host(chunk):
        images, tis = fields(chunk, 2, 3)  # images (bs, 1 or 2, H, W, 3)
        stack = np.concatenate([images[:, i] for i in
                                range(images.shape[1])], axis=0)
        inflight.append(([c[1] for c in chunk],
                         detector.process_batch(stack, tis)))
        drain()

    def run_raw(chunk):
        inflight.append(([c[1] for c in chunk],
                         detector.process_batch_raw(*fields(chunk, 2, 3, 4))))
        drain()

    # the cached path runs K batches per call: 64 (the JAX package's
    # default) or the whole split if shorter; K stays fixed per eval, the
    # last group repeating its tail batch
    scan_k = max(1, min(-(-n // bs), 64))
    cached_groups = []

    def flush_cached(force=False):
        while cached_groups and (force or len(cached_groups) >= scan_k):
            take = cached_groups[:scan_k]
            del cached_groups[:scan_k]
            full = take + [take[-1]] * (scan_k - len(take))
            dev = detector.process_batches_cached(
                cache_dev, *(np.stack([t[i] for t in full])
                             for i in (1, 2, 3)))
            # (K, B, topk, 6) -> (K * B, topk, 6); padded rows trail
            inflight.append(([i for t in take for i in t[0]],
                             dev.reshape((-1,) + tuple(dev.shape[2:]))))
            drain()

    def run_cached(chunk):
        ids = [c[1] for c in chunk]
        cols = fields(chunk, 2, 3, 4)
        if scan_k == 1:
            inflight.append((ids, detector.process_batch_cached(cache_dev,
                                                                *cols)))
            drain()
            return
        cached_groups.append([ids] + cols)
        flush_cached()

    runners = {"host": run_host, "raw": run_raw, "cached": run_cached}
    t_start = time.time()
    with ThreadPoolExecutor(max_workers=workers) as pool:
        # bounded window of outstanding loads (backpressure)
        window = workers + 2 * bs
        pending = deque(pool.submit(load_one, i)
                        for i in range(min(window, n)))
        nxt = len(pending)
        chunks = {kind: [] for kind in runners}
        done = 0
        while pending:
            t0 = time.time()
            item = pending.popleft().result()
            stage["stall"] += time.time() - t0
            if nxt < n:
                pending.append(pool.submit(load_one, nxt))
                nxt += 1
            kind = item[0]
            chunks[kind].append(item)
            if len(chunks[kind]) == bs:
                runners[kind](chunks[kind])
                done += bs
                chunks[kind] = []
                if done % (bs * 10) == 0:
                    print("[{}/{}] {:.1f} img/s".format(
                        done, n, done / (time.time() - t_start)))
        for kind, chunk in chunks.items():
            if chunk:
                runners[kind](chunk)
                done += len(chunk)
        flush_cached(force=True)
        drain(force=True)
    print("batched eval: {} images in {:.1f}s".format(
        done, time.time() - t_start))
    if opt.device_warp:
        print("device_warp: {} of {} frames larger than the {}x{} buffer "
              "took the host warp".format(len(host_fallbacks), n,
                                          *opt._device_warp_hw))
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
