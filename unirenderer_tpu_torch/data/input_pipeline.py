"""The input pipeline (counterpart of `unirenderer_tpu/data/input_pipeline.py`):
per-host sharding of a dataset's indices, a background-thread prefetcher,
the shard -> map(collate) -> prefetch stream over a dataset, and a cached
pool of collated batches.

On the card a prefetched collate runs on a side CUDA stream
(`device_prefetch`): the worker records an event after each batch, and
the consumer's stream waits on it before the batch is used (and the
batch's memory is marked as used by the consumer's stream), so the
render of the next batch overlaps the train step.  An error in the
worker is raised in the consumer.
"""

from __future__ import annotations

import contextlib
import glob
import itertools
import json
import os
import queue
import threading
from typing import Callable, Dict, Iterator, List, Optional

import numpy as np
import torch


def host_shard_indices(n: int, process_index: int, process_count: int,
                       seed: int = 0, shuffle: bool = True) -> List[int]:
    """This process's share of range(n): every process_count-th index of
    a seeded permutation, from `process_index`."""
    idx = np.arange(n)
    if shuffle:
        idx = np.random.default_rng(seed).permutation(idx)
    return [int(i) for i in idx[process_index::process_count]]


class ThreadedPrefetcher:
    """Background-thread batch producer: `make_batch(i)` for i = 0, 1, ...
    (up to `num_batches`), at most `depth` ahead of the consumer.  An
    exception of `make_batch` ends the stream and is raised in the
    consumer; `close` stops the worker and waits for it."""

    def __init__(self, make_batch: Callable[[int], object],
                 num_batches: Optional[int] = None, depth: int = 2):
        self._make = make_batch
        self._n = num_batches
        self._q: "queue.Queue" = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _put(self, item) -> bool:
        """Put unless stopped; False once stopped."""
        while not self._stop.is_set():
            try:
                self._q.put(item, timeout=0.05)
                return True
            except queue.Full:
                continue
        return False

    def _worker(self) -> None:
        i = 0
        while not self._stop.is_set():
            if self._n is not None and i >= self._n:
                self._put(None)
                return
            try:
                item = self._make(i)
            except BaseException as e:         # surfaced to the consumer
                self._put(e)
                return
            if not self._put(item):
                return
            i += 1

    def __iter__(self) -> Iterator:
        while True:
            item = self._q.get()
            if item is None:
                return
            if isinstance(item, BaseException):
                raise item
            yield item

    def close(self) -> None:
        self._stop.set()
        self._thread.join()
        with contextlib.suppress(queue.Empty):
            while True:
                self._q.get_nowait()


def input_pipeline(dataset, batch_size: int,
                   collate: Callable[[List[dict]], dict], seed: int = 0,
                   prefetch: int = 2, process_index: int = 0,
                   process_count: int = 1,
                   num_batches: Optional[int] = None) -> ThreadedPrefetcher:
    """Sharded, prefetched batch stream over an indexable dataset: this
    process's shuffled share of the indices, `batch_size` items a batch
    (wrapping around), each batch through `collate` in the worker."""
    idx = host_shard_indices(len(dataset), process_index, process_count,
                             seed)

    def make_batch(b):
        items = [dataset[idx[(b * batch_size + j) % len(idx)]]
                 for j in range(batch_size)]
        return collate(items)

    return ThreadedPrefetcher(make_batch, num_batches=num_batches,
                              depth=prefetch)


def device_prefetch(make_batch: Callable[[int], Dict[str, torch.Tensor]],
                    device, depth: int = 2,
                    num_batches: Optional[int] = None
                    ) -> Iterator[Dict[str, torch.Tensor]]:
    """`make_batch(i)` (a dict of tensors on `device`) in a prefetch
    thread, without a gradient; on a CUDA device on a side stream, the
    consumer's stream waiting on each batch's event before the batch is
    yielded.  The worker stops when the generator is closed."""
    device = torch.device(device)
    cuda = device.type == "cuda"
    side = torch.cuda.Stream(device) if cuda else None

    def produce(i):
        with torch.no_grad(), (torch.cuda.stream(side) if cuda
                               else contextlib.nullcontext()):
            maps = make_batch(i)
            event = torch.cuda.Event() if cuda else None
            if cuda:
                event.record(side)
        return maps, event

    pf = ThreadedPrefetcher(produce, num_batches=num_batches, depth=depth)
    try:
        for maps, event in pf:
            if cuda:
                consumer = torch.cuda.current_stream(device)
                consumer.wait_event(event)
                for t in maps.values():
                    if isinstance(t, torch.Tensor) and t.is_cuda:
                        t.record_stream(consumer)
            yield maps
    finally:
        pf.close()


def cached_batch_source(batches: Iterator, pool_size: int,
                        cache_dir: Optional[str] = None, seed: int = 0,
                        expect_batch: Optional[int] = None,
                        expect_resolution: Optional[int] = None
                        ) -> Iterator[Dict[str, np.ndarray]]:
    """Materialise `pool_size` collated batches once (to host memory, and
    to `cache_dir` as `b<i>.npz` shards with a `meta.json` when given),
    then yield batches drawn from the pool at random forever.  A populated
    `cache_dir` is reused.  `expect_batch` / `expect_resolution`: the
    consumer's batch size and image resolution; a pool that does not
    match raises instead of training at the pool's shape."""

    def validate(shape, src):
        if expect_batch is not None and shape[0] != expect_batch:
            raise ValueError(
                f"cached pool {src} has batch {shape[0]} but the consumer "
                f"expects global batch {expect_batch}; re-render with a "
                f"fresh --cache-dir or matching --batch")
        if expect_resolution is not None and shape[1] != expect_resolution:
            raise ValueError(
                f"cached pool {src} has resolution {shape[1]} but the "
                f"consumer expects {expect_resolution}; re-render with a "
                f"fresh --cache-dir or matching config")

    pool = []
    files = sorted(glob.glob(os.path.join(cache_dir, "b*.npz"))) \
        if cache_dir else []
    if len(files) >= pool_size:
        meta_path = os.path.join(cache_dir, "meta.json")
        if os.path.exists(meta_path):
            with open(meta_path) as f:
                validate(tuple(json.load(f)["image_shape"]), cache_dir)
        for path in files[:pool_size]:
            with np.load(path) as z:
                b = {k: z[k] for k in z.files}
            validate(b["image"].shape, path)
            pool.append(b)
    else:
        if cache_dir:
            os.makedirs(cache_dir, exist_ok=True)
        for i, b in enumerate(itertools.islice(batches, pool_size)):
            hb = {k: (v.detach().cpu().numpy() if isinstance(
                v, torch.Tensor) else np.asarray(v)) for k, v in b.items()}
            validate(hb["image"].shape, "(freshly rendered)")
            pool.append(hb)
            if cache_dir:
                np.savez(os.path.join(cache_dir, f"b{i:05d}.npz"), **hb)
        if cache_dir and pool:
            with open(os.path.join(cache_dir, "meta.json"), "w") as f:
                json.dump({"image_shape": list(pool[0]["image"].shape),
                           "keys": sorted(pool[0]),
                           "n_batches": len(pool)}, f)
    if not pool:
        raise ValueError("cached_batch_source: empty pool")
    close = getattr(batches, "close", None)
    if close:
        close()
    rng = np.random.default_rng(seed)
    while True:
        yield pool[int(rng.integers(len(pool)))]
