"""PyTorch/CUDA port of ``mxnet_tpu``, first slice: decode serving.

``serving.DecodeEngine`` drives ``serving.PagedCausalLM`` over a paged
KV pool; the paged attention both prefill chunks and decode
iterations run is a hand-written CUDA kernel
(``ops/csrc/paged_attention.cu``), built with ``nvcc`` at first use.
Module names mirror the JAX package's so each counterpart is found at
the same relative path. This package imports ``torch`` and nothing of
``jax`` or ``mxnet_tpu``.
"""
from __future__ import annotations

__version__ = "0.1.0"
