"""Threaded prefetch loader feeding fixed-shape batches to the trainer;
a copy of cvpce_tpu/data/loader.py (numpy and threads only).

Dataset __getitem__ runs on a thread pool, batches are collated to
static shapes, and the epoch order is a pure function of
(seed, epoch), so both packages and every resumed run see the same
batches.
"""
from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Iterator, Sequence

import numpy as np


class PrefetchLoader:
    def __init__(self, dataset, batch_size: int, collate: Callable,
                 shuffle: bool = True, num_threads: int = 8,
                 prefetch_batches: int = 2, seed: int = 0,
                 drop_last: bool = True,
                 shard_index: int = 0, num_shards: int = 1):
        """`shard_index`/`num_shards` give per-host data sharding, the
        equivalent of torch DistributedSampler (proposals_training.py:83)."""
        self.dataset = dataset
        self.batch_size = batch_size
        self.collate = collate
        self.shuffle = shuffle
        self.num_threads = num_threads
        self.prefetch_batches = prefetch_batches
        self.drop_last = drop_last
        self.shard_index = shard_index
        self.num_shards = num_shards
        self.seed = seed
        self.epoch = 0

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    def _order(self, epoch: int) -> np.ndarray:
        # a pure function of (seed, epoch): every process/host and every
        # resumed run sees the same epoch order (DistributedSampler
        # semantics, proposals_training.py:223-224)
        n = len(self.dataset)
        order = np.arange(n)
        if self.shuffle:
            order = np.random.default_rng((self.seed, epoch)).permutation(n)
        return order[self.shard_index::self.num_shards]

    def __len__(self) -> int:
        n = len(self._order(self.epoch))
        return n // self.batch_size if self.drop_last else \
            (n + self.batch_size - 1) // self.batch_size

    def __iter__(self) -> Iterator:
        return self._batches(self.epoch, 0)

    def _batches(self, epoch: int, start: int) -> Iterator:
        """Epoch `epoch`'s batches from batch `start` on; no item of an
        earlier batch is loaded."""
        order = self._order(epoch)
        nb = len(self)
        out_q: "queue.Queue" = queue.Queue(maxsize=self.prefetch_batches)
        stop = threading.Event()

        def _put(item) -> bool:
            """Put without deadlocking if the consumer went away."""
            while not stop.is_set():
                try:
                    out_q.put(item, timeout=0.5)
                    return True
                except queue.Full:
                    continue
            return False

        def produce():
            with ThreadPoolExecutor(self.num_threads) as pool:
                for b in range(start, nb):
                    if stop.is_set():
                        break
                    idxs = order[b * self.batch_size:(b + 1) * self.batch_size]
                    items = list(pool.map(self.dataset.__getitem__, idxs))
                    if not _put(self.collate(items)):
                        return
            _put(None)

        thread = threading.Thread(target=produce, daemon=True)
        thread.start()
        try:
            while True:
                batch = out_q.get()
                if batch is None:
                    break
                yield batch
        finally:
            stop.set()
            # drain so the producer can exit
            while thread.is_alive():
                try:
                    out_q.get_nowait()
                except queue.Empty:
                    break


def batch_iterator(items: Sequence, batch_size: int) -> Iterator:
    for i in range(0, len(items), batch_size):
        yield items[i:i + batch_size]
