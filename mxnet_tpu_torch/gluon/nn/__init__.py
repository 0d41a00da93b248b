"""Layers of the PyTorch port (``mxnet_tpu/gluon/nn``'s counterpart)."""
from __future__ import annotations

from .basic_layers import Activation, Dense, Dropout, Embedding, LayerNorm
from .transformer import (MultiHeadAttention, PositionwiseFFN,
                          TransformerEncoder, TransformerEncoderCell)

__all__ = ["Activation", "Dense", "Dropout", "Embedding", "LayerNorm",
           "MultiHeadAttention", "PositionwiseFFN", "TransformerEncoder",
           "TransformerEncoderCell"]
