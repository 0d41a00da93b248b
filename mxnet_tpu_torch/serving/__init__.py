"""Decode serving for the PyTorch port: :class:`DecodeEngine`
(continuous batching over a paged KV pool) driving
:class:`PagedCausalLM`.

Quickstart::

    from mxnet_tpu_torch.serving import DecodeEngine, PagedCausalLM

    model = PagedCausalLM(vocab=50257, units=768, layers=12, heads=12,
                          max_len=1024)             # on the current GPU
    with DecodeEngine(model, n_pages=1024) as eng:
        eng.warmup()
        fut = eng.submit([464, 2068, 7586], max_new_tokens=32,
                         stream=True)
        for part in fut.stream():
            print(part["token"])
"""
from __future__ import annotations

from .batcher import DecodeSlots, PrefillChunks
from .decode import DecodeEngine, DecodeRequest
from .decode_model import PagedCausalLM
from .kvcache import KVPagesExhaustedError, PagedKVPool
from .metrics import CostLedger, DecodeStats, ServingStats
from .queue import (DeadlineExceededError, EngineStoppedError,
                    InferenceFuture, InvalidSamplingError, QueueFullError,
                    RequestQueue, RequestTooLongError, ServingError,
                    UnknownModelError)

__all__ = ["CostLedger", "DeadlineExceededError", "DecodeEngine",
           "DecodeRequest", "DecodeSlots", "DecodeStats",
           "EngineStoppedError", "InferenceFuture", "InvalidSamplingError",
           "KVPagesExhaustedError", "PagedCausalLM", "PagedKVPool",
           "PrefillChunks", "QueueFullError", "RequestQueue",
           "RequestTooLongError", "ServingError", "ServingStats",
           "UnknownModelError"]
