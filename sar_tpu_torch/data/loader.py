"""Data loading (sar_tpu/data/loader.py without its worker pool): a seeded
shuffled index stream over a list-like dataset, collated in order on a
background thread (`prefetch` batches ahead), so host-side batch prep
overlaps the device's work; one epoch for evaluation, or an endless
stream of epochs for training. numpy only.
"""

from __future__ import annotations

import queue
import threading
from typing import Callable, Iterator

import numpy as np


class DataLoader:
    """`one_epoch(epoch)` yields one pass of collated batches, in the order
    of `np.random.default_rng(seed + epoch)` when shuffling; `iterate()`
    yields batches forever, epoch after epoch (reshuffled each time), and
    keeps `current_epoch` at the epoch of the batch it yielded last."""

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
        self.current_epoch = 0

    def _epoch_batches(self, epoch: int) -> Iterator[dict]:
        idx = np.arange(len(self.dataset))
        if self.shuffle:
            np.random.default_rng(self.seed + epoch).shuffle(idx)
        B = self.batch_size
        end = (len(idx) // B) * B if self.drop_last else len(idx)
        for s in range(0, end, B):
            yield self.collator([self.dataset[int(i)] for i in idx[s:s + B]])

    def one_epoch(self, epoch: int = 0) -> Iterator[dict]:
        yield from self._prefetched(self._epoch_batches(epoch))

    def iterate(self) -> Iterator[dict]:
        def forever():
            epoch = 0
            while True:
                for b in self._epoch_batches(epoch):
                    yield epoch, b
                epoch += 1
        for epoch, b in self._prefetched(forever()):
            self.current_epoch = epoch
            yield b

    def _prefetched(self, batches: Iterator) -> Iterator:
        """`batches`, collated on a background thread `prefetch` ahead."""
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
