"""Data loaders (counterpart of ``deepspeed_tpu/runtime/dataloader.py``;
reference ``runtime/dataloader.py``: DeepSpeedDataLoader, RepeatingLoader).

Works over anything indexable (numpy arrays, lists of dicts) and yields
micro-batches ``[batch_size, ...]`` as numpy; the engine moves them to the
device.  Single device: the batch is the whole micro-batch.
"""
from __future__ import annotations

from typing import Any, Iterator

import numpy as np


class RepeatingLoader:
    """Wrap an iterator to restart on StopIteration (reference dataloader.py)."""

    def __init__(self, loader):
        self.loader = loader
        self.data_iter = iter(self.loader)

    def __iter__(self):
        return self

    def __next__(self):
        try:
            return next(self.data_iter)
        except StopIteration:
            self.data_iter = iter(self.loader)
            return next(self.data_iter)


class DeepSpeedDataLoader:
    """Batches an indexable dataset into [batch_size, ...] numpy trees,
    reshuffled per epoch from ``seed + epoch``, or in the index batches a
    ``data_sampler`` draws (a curriculum sampler,
    ``data_pipeline/data_sampler.py``), one drawn per batch yielded."""

    def __init__(self, dataset: Any, batch_size: int, shuffle: bool = True,
                 seed: int = 0, drop_last: bool = True, collate_fn=None,
                 data_sampler=None):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        self.collate_fn = collate_fn
        self.data_sampler = data_sampler
        self.epoch = 0

    def __len__(self):
        n = len(self.dataset)
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def set_epoch(self, epoch: int):
        self.epoch = epoch

    def _indices(self) -> np.ndarray:
        idx = np.arange(len(self.dataset))
        if self.shuffle:
            np.random.RandomState(self.seed + self.epoch).shuffle(idx)
        return idx

    def _collate(self, items):
        if self.collate_fn is not None:
            return self.collate_fn(items)
        first = items[0]
        if isinstance(first, dict):
            return {k: np.stack([np.asarray(it[k]) for it in items]) for k in first}
        if isinstance(first, (tuple, list)):
            return tuple(np.stack([np.asarray(it[j]) for it in items])
                         for j in range(len(first)))
        return np.stack([np.asarray(it) for it in items])

    def _iter_sampler(self) -> Iterator:
        """Lazy: one index batch drawn per batch yielded, so a curriculum
        sampler's consumed-batch count (and its checkpointed state) tracks
        the batches trained."""
        it = iter(self.data_sampler)
        buf: list = []
        produced = 0
        while produced < len(self):
            try:
                b = next(it)
            except StopIteration:
                break
            buf.extend(b if hasattr(b, "__len__") else [b])
            while len(buf) >= self.batch_size and produced < len(self):
                sel, buf = buf[:self.batch_size], buf[self.batch_size:]
                produced += 1
                yield self._collate([self.dataset[int(i)] for i in sel])

    def __iter__(self) -> Iterator:
        if self.data_sampler is not None:
            yield from self._iter_sampler()
            self.epoch += 1
            return
        idx = self._indices()
        for b in range(len(self)):
            sel = idx[b * self.batch_size:(b + 1) * self.batch_size]
            yield self._collate([self.dataset[int(i)] for i in sel])
        self.epoch += 1
