"""Gluon of the PyTorch port (``mxnet_tpu/gluon``'s counterpart,
reduced to what BERT serving and training use): ``nn`` layers as
``torch.nn.Module``s with Gluon's parameter names, ``model_zoo.bert``,
``Parameter``/``ParameterDict``, ``loss`` and the ``Trainer``."""
from __future__ import annotations

from . import loss, model_zoo, nn
from .block import Block
from .parameter import Parameter, ParameterDict
from .trainer import Trainer

__all__ = ["Block", "Parameter", "ParameterDict", "Trainer", "loss",
           "model_zoo", "nn"]
