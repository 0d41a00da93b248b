"""DataLoader (``mxnet_tpu/gluon/data/dataloader.py``'s counterpart).

Batches are built on the host (numpy, or torch tensors a dataset or
transform gives) and land on the loader's ``device``: ``None`` is the
current context's device (the card unless a ``with mx.cpu():`` scope
is active) and raises without a card, as the JAX loader puts its
batches on the current context; pass ``device="cpu"`` for the CPU.
The default batchify gives ``NDArray`` batches, as the reference's;
:func:`tensor_batchify_fn` gives plain tensors (the port's own
training loops use it, so no NDArray dispatch enters their steps).
Floating-point numpy data arrives as float32 (MXNet's default type).
``num_workers=0`` builds each batch in the caller's thread;
``num_workers > 0`` with ``thread_pool=True`` builds ``prefetch``
batches ahead on that many threads, each awaited at most ``timeout``
seconds. ``pin_memory`` stages each batch in page-locked host memory
and copies it to the card asynchronously; one card has
``pin_device_id`` 0 only. Process workers and ``DevicePrefetcher``
are not ported yet (ROADMAP Queue 1, 'Vision remainders'). A shuffle
draws from ``rng`` (a numpy generator; see ``sampler.RandomSampler``).
"""
from __future__ import annotations

import concurrent.futures as _futures
from collections import deque

import numpy as np
import torch

from ...context import resolve_device
from ...ndarray.ndarray import NDArray, as_nd
from .sampler import BatchSampler, RandomSampler, SequentialSampler

__all__ = ["DataLoader", "default_batchify_fn", "tensor_batchify_fn"]


def tensor_batchify_fn(data):
    """Stack samples into a batch: a tuple of fields gives a list of
    batches; numpy and numbers become a CPU tensor (float64 as
    float32)."""
    if isinstance(data[0], torch.Tensor):
        return torch.stack([d.as_subclass(torch.Tensor) for d in data], 0)
    if isinstance(data[0], tuple):
        return [tensor_batchify_fn(list(field)) for field in zip(*data)]
    arr = np.asarray(data)
    if arr.dtype == np.float64:
        arr = arr.astype(np.float32)
    return torch.from_numpy(arr)


def default_batchify_fn(data):
    """:func:`tensor_batchify_fn`'s batches as NDArrays."""
    return _as_nd(tensor_batchify_fn(data))


def _as_nd(batch):
    if isinstance(batch, torch.Tensor):
        return as_nd(batch)
    if isinstance(batch, list):
        return [_as_nd(b) for b in batch]
    return batch


def _to_device(batch, device, pin=False):
    if isinstance(batch, torch.Tensor):
        if pin and batch.device != device:
            return batch.pin_memory().to(device, non_blocking=True)
        return batch.to(device)
    if isinstance(batch, (list, tuple)):
        return [_to_device(b, device, pin) for b in batch]
    return batch


class DataLoader:
    """Batches of ``dataset`` (see the module docstring)."""

    def __init__(self, dataset, batch_size=None, shuffle=False, sampler=None,
                 last_batch=None, batch_sampler=None, batchify_fn=None,
                 num_workers=0, pin_memory=False, pin_device_id=0,
                 prefetch=None, thread_pool=False, timeout=120,
                 device=None, rng=None):
        if pin_device_id != 0:
            raise ValueError(f"pin_device_id {pin_device_id!r}: one card "
                             f"has pin_device_id 0 only")
        if num_workers > 0 and not thread_pool:
            raise NotImplementedError(
                "process workers are not ported yet (ROADMAP Queue 1, "
                "'Vision remainders'); pass thread_pool=True or "
                "num_workers=0")
        self._dataset = dataset
        self._device = resolve_device(device)
        self._pin = bool(pin_memory) and self._device.type == "cuda"
        self._timeout = timeout
        self._num_workers = max(0, num_workers)
        self._prefetch = max(0, prefetch or 2 * self._num_workers)
        if batch_sampler is None:
            if batch_size is None:
                raise ValueError("batch_size must be specified unless "
                                 "batch_sampler is specified")
            if sampler is None:
                sampler = RandomSampler(len(dataset), rng) if shuffle \
                    else SequentialSampler(len(dataset))
            elif shuffle:
                raise ValueError("shuffle must not be specified if sampler "
                                 "is specified")
            batch_sampler = BatchSampler(sampler, batch_size,
                                         last_batch or "keep")
        elif batch_size is not None or shuffle or sampler is not None or \
                last_batch is not None:
            raise ValueError("batch_size, shuffle, sampler and last_batch "
                             "must not be specified if batch_sampler is "
                             "specified.")
        self._batch_sampler = batch_sampler
        self._batchify_fn = batchify_fn or default_batchify_fn

    def _batch(self, indices):
        return self._batchify_fn([self._dataset[i] for i in indices])

    def __iter__(self):
        if self._num_workers == 0:
            return (_to_device(self._batch(b), self._device, self._pin)
                    for b in self._batch_sampler)
        return _ThreadedIter(self)

    def __len__(self):
        return len(self._batch_sampler)


class _ThreadedIter:
    """``prefetch`` batches built ahead on a thread pool, handed out in
    order."""

    def __init__(self, loader):
        self._loader = loader
        self._pool = _futures.ThreadPoolExecutor(
            max_workers=loader._num_workers,
            thread_name_prefix="mxnet_tpu_torch_dataloader")
        self._batches = iter(loader._batch_sampler)
        self._pending = deque()
        for _ in range(max(1, loader._prefetch)):
            self._submit_next()

    def _submit_next(self):
        batch = next(self._batches, None)
        if batch is not None:
            self._pending.append(self._pool.submit(self._loader._batch,
                                                   batch))

    def __iter__(self):
        return self

    def __next__(self):
        if not self._pending:
            self._pool.shutdown(wait=False)
            raise StopIteration
        fut = self._pending.popleft()
        self._submit_next()
        try:
            loader = self._loader
            return _to_device(fut.result(timeout=loader._timeout),
                              loader._device, loader._pin)
        except BaseException:
            self._pool.shutdown(wait=False, cancel_futures=True)
            raise

    def __del__(self):
        # abandoned mid-epoch: release the worker threads
        self._pool.shutdown(wait=False, cancel_futures=True)
