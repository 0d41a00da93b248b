"""Samplers (``mxnet_tpu/gluon/data/sampler.py``'s counterpart, numpy
only). ``RandomSampler`` shuffles with an explicit generator: a
``numpy.random.RandomState(s)`` gives the JAX package's order after
``np.random.seed(s)``."""
from __future__ import annotations

import numpy as np

__all__ = ["BatchSampler", "RandomSampler", "Sampler", "SequentialSampler"]

_LAST_BATCH = ("keep", "discard", "rollover")


class Sampler:
    def __iter__(self):
        raise NotImplementedError

    def __len__(self):
        raise NotImplementedError


class SequentialSampler(Sampler):
    """``start, start + 1, ..., start + length - 1``."""

    def __init__(self, length, start=0):
        self._length = length
        self._start = start

    def __iter__(self):
        return iter(range(self._start, self._start + self._length))

    def __len__(self):
        return self._length


class RandomSampler(Sampler):
    """A fresh permutation of ``range(length)`` each pass, drawn from
    ``rng`` (a ``numpy.random.Generator`` or ``RandomState``; a new
    unseeded ``default_rng()`` when None)."""

    def __init__(self, length, rng=None):
        self._length = length
        self._rng = np.random.default_rng() if rng is None else rng

    def __iter__(self):
        indices = np.arange(self._length)
        self._rng.shuffle(indices)
        return iter(indices.tolist())

    def __len__(self):
        return self._length


class BatchSampler(Sampler):
    """Lists of ``batch_size`` indices from ``sampler``; the last short
    batch is kept, discarded or rolled over into the next pass."""

    def __init__(self, sampler, batch_size, last_batch="keep"):
        if last_batch not in _LAST_BATCH:
            raise ValueError(f"last_batch must be one of {_LAST_BATCH}, "
                             f"but got {last_batch}")
        self._sampler = sampler
        self._batch_size = batch_size
        self._last_batch = last_batch
        self._prev = []

    def __iter__(self):
        batch, self._prev = self._prev, []
        for i in self._sampler:
            batch.append(i)
            if len(batch) == self._batch_size:
                yield batch
                batch = []
        if batch:
            if self._last_batch == "keep":
                yield batch
            elif self._last_batch == "rollover":
                self._prev = batch

    def __len__(self):
        if self._last_batch == "keep":
            return (len(self._sampler) + self._batch_size - 1) \
                // self._batch_size
        if self._last_batch == "discard":
            return len(self._sampler) // self._batch_size
        return (len(self._prev) + len(self._sampler)) // self._batch_size
