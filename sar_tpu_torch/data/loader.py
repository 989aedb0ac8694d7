"""Data loading (the evaluation part of sar_tpu/data/loader.py): a seeded
shuffled index stream over a list-like dataset, collated in order on a
background thread (`prefetch` batches ahead), so host-side batch prep
overlaps the device's work. numpy only.
"""

from __future__ import annotations

import queue
import threading
from typing import Callable, Iterator

import numpy as np


class DataLoader:
    """`one_epoch(epoch)` yields one pass of collated batches, in the order
    of `np.random.default_rng(seed + epoch)` when shuffling."""

    def __init__(self, dataset, batch_size: int, collator: Callable,
                 shuffle: bool = True, seed: int = 42, drop_last: bool = True,
                 prefetch: int = 2):
        self.dataset = dataset
        self.batch_size = batch_size
        self.collator = collator
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        self.prefetch = prefetch

    def _epoch_batches(self, epoch: int) -> Iterator[dict]:
        idx = np.arange(len(self.dataset))
        if self.shuffle:
            np.random.default_rng(self.seed + epoch).shuffle(idx)
        B = self.batch_size
        end = (len(idx) // B) * B if self.drop_last else len(idx)
        for s in range(0, end, B):
            yield self.collator([self.dataset[int(i)] for i in idx[s:s + B]])

    def one_epoch(self, epoch: int = 0) -> Iterator[dict]:
        batches = self._epoch_batches(epoch)
        if self.prefetch <= 0:
            yield from batches
            return
        q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        stop = object()

        def worker():
            try:
                for item in batches:
                    q.put(item)
                q.put(stop)
            except BaseException as e:   # handed to the consumer
                q.put(e)

        threading.Thread(target=worker, daemon=True).start()
        while True:
            item = q.get()
            if item is stop:
                return
            if isinstance(item, BaseException):
                raise item
            yield item

    def __len__(self):
        n = len(self.dataset) // self.batch_size
        return n if self.drop_last else -(-len(self.dataset) // self.batch_size)
