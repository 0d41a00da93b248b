"""PyTorch/CUDA port of ``mxnet_tpu``: decode and encoder serving, and
BERT, LSTM word-LM, ResNet, MNIST and Wide & Deep training.

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
``layer_norm.cu``, ``softmax_xent.cu``), and the LSTM word LM's
whole-sequence LSTM through ``ops/csrc/lstm.cu``. The vision path
(``gluon.model_zoo.vision`` ResNets over ``gluon.nn``'s convolution,
pooling and BatchNorm layers, ``gluon.data``, ``metric``) trains
ResNet-50 ImageNet-style and the MNIST MLP (``examples/``); its
convolutions and pooling run in cuDNN through torch, as the JAX
package leaves them to XLA (no hand-written kernel there). The
Wide & Deep recommender (``gluon.model_zoo.wide_deep``) trains on the
sparse machinery: ``ndarray.sparse`` (row_sparse and csr arrays, the
sparse ``dot``, the optimizers' lazy row updates), the single-process
``kvstore`` (``mx.kv``: push, pull, ``row_sparse_pull``) and ``io``'s
``LibSVMIter``; its gathers, sums and GEMMs are torch's, as the JAX
package leaves them to XLA.
The symbolic API (``mx.sym``, ``Executor``, ``mx.mod``'s ``Module`` and
``BucketingModule``, ``mx.rnn``'s legacy cells, ``model``,
``callback``, ``monitor`` and ``gluon.SymbolBlock``) binds a Symbol
graph over the same op registry; on the card a bound graph runs as
CUDA graphs, as hybridized blocks do.
Module names mirror the JAX package's so each counterpart is found at
the same relative path, and the top-level names are the reference's
(``mx.nd``, ``mx.cpu()``, ``mx.current_context()``, ...): the JAX
package's own Gluon scripts run on the port as written
(``examples/run_reference.py``). Parameters travel in the reference's
``.params`` files (``nd.save``/``nd.load``, ``Block.save_parameters``,
``checkpoint.CheckpointManager``). ``mx.nd`` holds the reference's op
registry (``mx.nd.FullyConnected``, ``mx.nd.broadcast_add``, ...:
``ndarray/register.py``), and a user's ``HybridBlock`` runs its
``hybrid_forward(F, x, ...)`` with ``F`` that namespace; ``random``,
``engine``, ``name``, ``attribute``, ``util`` and ``test_utils`` are
the reference's runtime modules. This package imports ``torch`` and
nothing of ``jax`` or ``mxnet_tpu``.
"""
from __future__ import annotations

from . import autograd, checkpoint, context, gluon, initializer
from . import io, kvstore, lr_scheduler, metric, ndarray, optimizer
from . import attribute, engine, name, random, test_utils, util
from . import callback, executor, model, module, monitor, rnn, symbol
from . import initializer as init
from . import kvstore as kv
from . import module as mod
from . import ndarray as nd
from . import symbol as sym
from .base import MXNetError
from .context import Context, cpu, current_context, gpu, num_gpus
from .executor import Executor
from .ndarray import NDArray
from .symbol import Symbol

__version__ = "0.1.0"
__all__ = ["Context", "Executor", "MXNetError", "NDArray", "Symbol",
           "attribute", "autograd", "callback", "checkpoint", "context",
           "cpu", "current_context", "engine", "executor", "gluon", "gpu",
           "init", "initializer", "io", "kv", "kvstore", "lr_scheduler",
           "metric", "mod", "model", "module", "monitor", "name", "nd",
           "ndarray", "num_gpus", "optimizer", "random", "rnn", "sym",
           "symbol", "test_utils", "util"]
