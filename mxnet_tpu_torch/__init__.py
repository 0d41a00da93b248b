"""PyTorch/CUDA port of ``mxnet_tpu``: decode and encoder serving.

``serving.DecodeEngine`` drives ``serving.PagedCausalLM`` over a paged
KV pool; the paged attention both prefill chunks and decode
iterations run is a hand-written CUDA kernel
(``ops/csrc/paged_attention.cu``). ``serving.ServingEngine`` packs
variable-length requests into rows and runs a BERT forward
(``gluon.model_zoo.bert``) whose attention and LayerNorms are
hand-written CUDA kernels too (``ops/csrc/flash_attention.cu``,
``ops/csrc/layer_norm.cu``). Every kernel is built with ``nvcc`` at
first use.
Module names mirror the JAX package's so each counterpart is found at
the same relative path. This package imports ``torch`` and nothing of
``jax`` or ``mxnet_tpu``.
"""
from __future__ import annotations

__version__ = "0.1.0"
