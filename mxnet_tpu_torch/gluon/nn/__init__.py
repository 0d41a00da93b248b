"""Layers of the PyTorch port (``mxnet_tpu/gluon/nn``'s counterpart)."""
from __future__ import annotations

from ..block import Block, HybridBlock
from .basic_layers import (Activation, BatchNorm, Dense, Dropout, Embedding,
                           Flatten, HybridLambda, HybridSequential, Identity,
                           Lambda, LayerNorm, Sequential)
from .conv_layers import (AvgPool1D, AvgPool2D, AvgPool3D, Conv1D, Conv2D,
                          Conv3D, GlobalAvgPool1D, GlobalAvgPool2D,
                          GlobalAvgPool3D, GlobalMaxPool1D, GlobalMaxPool2D,
                          GlobalMaxPool3D, MaxPool1D, MaxPool2D, MaxPool3D)
from .transformer import (MultiHeadAttention, PositionwiseFFN,
                          TransformerEncoder, TransformerEncoderCell)

__all__ = ["Activation", "AvgPool1D", "AvgPool2D", "AvgPool3D", "BatchNorm",
           "Block", "Conv1D", "Conv2D", "Conv3D", "Dense", "Dropout",
           "Embedding", "Flatten", "GlobalAvgPool1D", "GlobalAvgPool2D",
           "GlobalAvgPool3D", "GlobalMaxPool1D", "GlobalMaxPool2D",
           "GlobalMaxPool3D", "HybridBlock", "HybridLambda",
           "HybridSequential", "Identity", "Lambda", "LayerNorm", "MaxPool1D",
           "MaxPool2D", "MaxPool3D", "MultiHeadAttention", "PositionwiseFFN",
           "Sequential", "TransformerEncoder", "TransformerEncoderCell"]
