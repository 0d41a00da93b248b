"""Execution engine: MXNet's ``engine`` module on torch's streams.

Port of ``mxnet_tpu/engine.py``. CUDA already gives the eager API
MXNet's asynchronous contract (a launch returns at once; a host read
waits), so what remains is :class:`Engine` with ``wait_for_var`` and
``wait_all`` (``torch.cuda.synchronize`` when a card is in use; the
CPU runs synchronously and there is nothing to wait for), and
:func:`set_bulk_size` /
:class:`bulk`, which keep their return values and change nothing (the
compiled step they would bound is ROADMAP Queue 1, 'Hybridize', as is
``chain_steps``).
"""
from __future__ import annotations

import os

import torch

__all__ = ["Engine", "bulk", "engine", "set_bulk_size"]


def _cuda_in_use():
    return torch.cuda.is_available() and torch.cuda.is_initialized()


class Engine:
    """The engine singleton (:data:`engine`)."""

    def wait_for_var(self, array):
        """Wait until ``array`` is computed (its device's stream)."""
        if isinstance(array, torch.Tensor) and array.is_cuda:
            torch.cuda.current_stream(array.device).synchronize()

    def wait_all(self):
        """Wait for every queued operation on every card."""
        if _cuda_in_use():
            torch.cuda.synchronize()


engine = Engine()

_BULK_SIZE = [int(os.environ.get("MXNET_EXEC_BULK_EXEC_MAX_NODE_TRAIN",
                                 "15"))]


def set_bulk_size(size):
    """Set the bulk size; returns the previous one (no effect here)."""
    prev, _BULK_SIZE[0] = _BULK_SIZE[0], int(size)
    return prev


class bulk:
    """``with mx.engine.bulk(16): ...`` (sets and restores the size)."""

    def __init__(self, size):
        self.size = size
        self._prev = None

    def __enter__(self):
        self._prev = set_bulk_size(self.size)
        return self

    def __exit__(self, *exc):
        set_bulk_size(self._prev)
        return False
