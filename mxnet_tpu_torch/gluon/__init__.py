"""Gluon layers of the PyTorch port (``mxnet_tpu/gluon``'s
counterpart, reduced to what the BERT encoder serving path uses):
``nn`` layers as ``torch.nn.Module``s with Gluon's parameter names, and
``model_zoo.bert``."""
from __future__ import annotations

from . import model_zoo, nn
from .block import Block

__all__ = ["Block", "model_zoo", "nn"]
