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
CUDA graphs, as hybridized blocks do. Detection (``nd.contrib``'s
MultiBox, NMS and vision ops: ``ops/detection.py``,
``ops/vision_contrib.py``) trains SSD over VGG-16
(``examples/ssd.py``) from RecordIO input (``recordio``, ``image``'s
augmenters and ``ImageDetIter``, ``io.ImageRecordIter``). Gluon models
deploy as MXNet's do: ``export`` writes the built-in layers' symbolic
forms (the JAX package's graph, letter for letter), ``SymbolBlock`` and
``Module`` import it, ``contrib.quantization.quantize_net`` rewrites a
net to int8 (exact int32 products), ``nd.contrib``'s
``foreach``/``while_loop``/``cond`` are the control-flow ops and
``mx.viz`` summarizes a graph. ``contrib.amp`` trains in mixed
precision by MXNet's op lists (bfloat16, or float16 with loss scaling),
``gluon.contrib.estimator`` fits a model through event handlers and
``contrib.tensorboard`` writes TensorBoard's event files. ``mx.np`` and
``mx.npx`` are MXNet's deep-NumPy frontend (``numpy``,
``numpy_extension``): ``mx.np.ndarray``, NumPy's functions over the op
registry, ``np.linalg``/``np.random``, ``mx.sym.np``/``mx.sym.npx``,
and np-mode Gluon under ``npx.set_np()``, whose models run on plain
tensors inside and launch the classic path's kernels.
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
from . import operator
from . import filesystem, image, recordio, runtime
from . import contrib, visualization
from . import visualization as viz
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

# mx.np / mx.npx, the NumPy frontend: its _npi_* ops join mx.nd and
# mx.sym; F.np / F.npx on the nd module that hybrid_forward gets, and
# their symbolic forms on mx.sym
from . import numpy as np  # noqa: A001
from . import numpy, numpy_extension  # noqa: E402
from . import numpy_extension as npx  # noqa: E402
from .ndarray import register as _register  # noqa: E402
from .symbol import numpy as _sym_np  # noqa: E402
from .symbol import numpy_extension as _sym_npx  # noqa: E402
from .symbol.symbol import _populate_symbol_ops  # noqa: E402
from .util import is_np_array  # noqa: E402

_NPI = {n for n in _register.list_ops() if n.startswith("_npi_")}
_register.populate_namespace(ndarray.__name__, _NPI)
_populate_symbol_ops(symbol, _NPI)
ndarray.np, ndarray.npx = np, npx
symbol.np, symbol.npx = _sym_np, _sym_npx

__version__ = "0.1.0"
__all__ = ["Context", "Executor", "MXNetError", "NDArray", "Symbol",
           "attribute", "autograd", "callback", "checkpoint", "context",
           "contrib", "cpu", "current_context", "engine", "executor", "filesystem",
           "gluon", "gpu", "image", "init", "initializer", "io", "kv", "kvstore", "lr_scheduler",
           "is_np_array", "metric", "mod", "model", "module", "monitor",
           "name", "nd", "ndarray", "np", "npx", "num_gpus", "numpy",
           "numpy_extension", "operator", "optimizer", "random", "recordio",
           "rnn", "runtime",
           "sym", "symbol", "test_utils", "util", "visualization", "viz"]
