"""Gluon of the PyTorch port (``mxnet_tpu/gluon``'s counterpart,
reduced to what its training and serving paths use): ``nn`` layers
(Dense, Embedding, LayerNorm, BatchNorm, the convolutions and pooling,
Sequential, the Transformer encoder) as ``torch.nn.Module``s with
Gluon's parameter names, ``rnn.LSTM``, ``model_zoo`` (BERT and the
vision ResNets), ``data`` (datasets, samplers, ``DataLoader``, the
vision datasets and transforms), ``Parameter``/``ParameterDict``,
``loss``, ``utils`` and the ``Trainer``. A ``HybridBlock`` hybridizes
into CUDA graphs (``block``'s module docstring); a plain ``Block`` runs
eagerly. ``SymbolBlock`` runs an ``mx.sym`` graph (an export) as a
block."""
from __future__ import annotations

from . import data, loss, model_zoo, nn, rnn, utils
from .block import Block, HybridBlock, SymbolBlock
from .parameter import Parameter, ParameterDict
from .trainer import Trainer

__all__ = ["Block", "HybridBlock", "Parameter", "ParameterDict",
           "SymbolBlock", "Trainer", "data", "loss", "model_zoo", "nn", "rnn",
           "utils"]
