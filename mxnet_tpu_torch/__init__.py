"""PyTorch/CUDA port of ``mxnet_tpu``: decode and encoder serving, and
BERT training.

``serving.DecodeEngine`` drives ``serving.PagedCausalLM`` over a paged
KV pool; the paged attention both prefill chunks and decode
iterations run is a hand-written CUDA kernel
(``ops/csrc/paged_attention.cu``). ``serving.ServingEngine`` packs
variable-length requests into rows and runs a BERT forward
(``gluon.model_zoo.bert``) whose attention and LayerNorms are
hand-written CUDA kernels too (``ops/csrc/flash_attention.cu``,
``ops/csrc/layer_norm.cu``). Every kernel is built with ``nvcc`` at
first use. Training goes through the MXNet contract
(``autograd.record()`` -> forward -> loss -> ``backward()`` ->
``gluon.Trainer.step()``): the flash attention, LayerNorm and fused
softmax cross-entropy of that path differentiate through hand-written
backward kernels (``ops/csrc/flash_attention_bwd.cu``,
``layer_norm.cu``, ``softmax_xent.cu``).
Module names mirror the JAX package's so each counterpart is found at
the same relative path. This package imports ``torch`` and nothing of
``jax`` or ``mxnet_tpu``.
"""
from __future__ import annotations

from . import autograd, gluon, lr_scheduler, ndarray, optimizer
from . import ndarray as nd

__version__ = "0.1.0"
__all__ = ["autograd", "gluon", "lr_scheduler", "nd", "ndarray",
           "optimizer"]
