"""Prefetching data loader (thread or forked-process workers), ported from
prismer_tpu/data/loader.py.

Replaces torch's DataLoader as the reference uses it (dataset/__init__.py:
36-43: shuffle + drop_last in train, 8 workers) with the JAX package's
index order: shuffle with numpy's `default_rng(seed + epoch)`, then the
shard (`shard_id::num_shards`), then `drop_last`. Batches are collated to
contiguous numpy arrays; data/device.py moves them to the card.

Workers run numpy and the host decoder only: they touch no CUDA (the
parent holds the device), and the feature tables they share are numpy.
Forked workers get a fresh module-level `random` state each (Python
reseeds it in every forked child), so they do not repeat one another's
augmentation draws. `worker_type="auto"` takes PRISMER_WORKER_TYPE=thread
or process when it is set, as the JAX package does; else it forks
processes when there are at least two workers and two cores, and uses
threads otherwise (the decoder's foreign calls release the GIL, the numpy
glue mostly does not).
"""

from __future__ import annotations

import multiprocessing
import os
import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Callable, Dict, Iterator, List, Optional

import numpy as np

_WORKER_DS = None


def _proc_init(dataset):
    global _WORKER_DS
    _WORKER_DS = dataset


def _proc_get(index):
    return _WORKER_DS[index]


def default_collate(records: List[Dict[str, Any]]) -> Dict[str, Any]:
    """Stack numpy leaves; lists of strings stay lists."""
    out: Dict[str, Any] = {}
    first = records[0]
    for key, val in first.items():
        vals = [r[key] for r in records]
        if isinstance(val, dict):
            out[key] = default_collate(
                [dict(v) for v in vals])
        elif isinstance(val, np.ndarray):
            out[key] = np.stack(vals)
        elif isinstance(val, (np.floating, np.integer, float, int)):
            out[key] = np.asarray(vals)
        else:
            out[key] = vals  # strings etc.
    return out


class DataLoader:
    def __init__(self, dataset, batch_size: int, train: bool,
                 num_workers: int = 8, seed: int = 42,
                 shard_id: int = 0, num_shards: int = 1,
                 collate_fn: Optional[Callable] = None,
                 prefetch: int = 4, drop_last: Optional[bool] = None,
                 worker_type: str = "auto"):
        self.dataset = dataset
        self.batch_size = batch_size
        self.train = train
        self.num_workers = max(1, num_workers)
        self.seed = seed
        self.shard_id = shard_id
        self.num_shards = num_shards
        self.collate = collate_fn or default_collate
        self.prefetch = prefetch
        self.drop_last = train if drop_last is None else drop_last
        if worker_type not in ("thread", "process", "auto"):
            raise ValueError(f"worker_type {worker_type!r}")
        env = os.environ.get("PRISMER_WORKER_TYPE")
        if worker_type == "auto" and env:
            # the JAX package's override of "auto"
            if env not in ("thread", "process"):
                raise ValueError(f"PRISMER_WORKER_TYPE={env!r}: thread or "
                                 "process")
            worker_type = env
        elif worker_type == "auto":
            try:
                cores = len(os.sched_getaffinity(0))
            except AttributeError:
                cores = os.cpu_count() or 1
            worker_type = ("process" if self.num_workers >= 2 and cores >= 2
                           and hasattr(os, "fork") else "thread")
        self.worker_type = worker_type
        self.epoch = 0

    def _indices(self) -> np.ndarray:
        n = len(self.dataset)
        idx = np.arange(n)
        if self.train:
            rng = np.random.default_rng(self.seed + self.epoch)
            rng.shuffle(idx)
        return idx[self.shard_id::self.num_shards]

    def __len__(self) -> int:
        n = len(self._indices())
        if self.drop_last:
            return n // self.batch_size
        return -(-n // self.batch_size)

    def __iter__(self) -> Iterator[Dict[str, Any]]:
        idx = self._indices()
        if self.drop_last:
            idx = idx[: (len(idx) // self.batch_size) * self.batch_size]
        batches = [idx[i:i + self.batch_size]
                   for i in range(0, len(idx), self.batch_size)]
        self.epoch += 1

        q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def put(item) -> None:
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return
                except queue.Full:
                    pass

        def produce():
            if self.worker_type == "process":
                ctx = multiprocessing.get_context("fork")
                pool = ctx.Pool(self.num_workers, initializer=_proc_init,
                                initargs=(self.dataset,))
                get, close = pool.map, pool.terminate
                fn = _proc_get
            else:
                pool = ThreadPoolExecutor(self.num_workers)
                get, close = pool.map, lambda: pool.shutdown(wait=False)
                fn = self.dataset.__getitem__
            try:
                for batch_idx in batches:
                    if stop.is_set():
                        return
                    put(self.collate(list(get(fn, list(batch_idx)))))
                put(None)
            except BaseException as e:  # re-raised by the consumer
                put(_Failed(e))
            finally:
                close()

        t = threading.Thread(target=produce, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is None:
                    return
                if isinstance(item, _Failed):
                    raise item.error
                yield item
        finally:
            stop.set()
            t.join()


class _Failed:
    def __init__(self, error: BaseException):
        self.error = error


def create_loader(dataset, batch_size: int, num_workers: int = 8,
                  train: bool = False, **kw) -> DataLoader:
    """Factory matching dataset/__init__.py:36-43."""
    return DataLoader(dataset, batch_size=batch_size, train=train,
                      num_workers=num_workers, **kw)
