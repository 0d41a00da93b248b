"""Gluon of the PyTorch port (``mxnet_tpu/gluon``'s counterpart,
reduced to what BERT serving and training and the LSTM word LM use):
``nn`` layers as ``torch.nn.Module``s with Gluon's parameter names,
``rnn.LSTM``, ``model_zoo.bert``, ``Parameter``/``ParameterDict``,
``loss``, ``utils.clip_global_norm`` and the ``Trainer``."""
from __future__ import annotations

from . import loss, model_zoo, nn, rnn, utils
from .block import Block
from .parameter import Parameter, ParameterDict
from .trainer import Trainer

__all__ = ["Block", "Parameter", "ParameterDict", "Trainer", "loss",
           "model_zoo", "nn", "rnn", "utils"]
