"""Serving for the PyTorch port: encoder serving with
:class:`ServingEngine` (packed rows through a BERT forward), and decode
serving with :class:`DecodeEngine` (continuous batching over a paged
KV pool) driving :class:`PagedCausalLM`.

Encoder quickstart::

    from mxnet_tpu_torch.gluon.model_zoo.bert import (BERTModel,
                                                      bert_serving_entry)
    from mxnet_tpu_torch.serving import ServingEngine

    net = BERTModel(seed=0)                       # BERT-base, on the GPU
    with ServingEngine(bert_serving_entry(net), pool="mean",
                       bucket_lens=(64, 256, 512)) as eng:
        eng.warmup()
        vec = eng.infer([101, 7592, 2088, 102])   # (768,) mean-pooled

Decode quickstart::

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

from .batcher import (ContinuousBatcher, DecodeSlots, PackedPlan,
                      PrefillChunks)
from .decode import DecodeEngine, DecodeRequest
from .decode_model import PagedCausalLM
from .engine import ServingEngine
from .kvcache import KVPagesExhaustedError, PagedKVPool
from .metrics import CostLedger, DecodeStats, ServingStats
from .queue import (DeadlineExceededError, EngineStoppedError,
                    InferenceFuture, InvalidSamplingError, QueueFullError,
                    RequestQueue, RequestTooLongError, ServingError,
                    UnknownModelError)

__all__ = ["ContinuousBatcher", "CostLedger", "DeadlineExceededError",
           "DecodeEngine", "DecodeRequest", "DecodeSlots", "DecodeStats",
           "EngineStoppedError", "InferenceFuture", "InvalidSamplingError",
           "KVPagesExhaustedError", "PackedPlan", "PagedCausalLM",
           "PagedKVPool", "PrefillChunks", "QueueFullError",
           "RequestQueue", "RequestTooLongError", "ServingEngine",
           "ServingError", "ServingStats", "UnknownModelError"]
