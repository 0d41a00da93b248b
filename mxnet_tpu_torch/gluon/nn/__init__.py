"""Layers of the PyTorch port (``mxnet_tpu/gluon/nn``'s counterpart)."""
from __future__ import annotations

from ..block import Block, HybridBlock
from .basic_layers import (ELU, GELU, SELU, Activation, BatchNorm, Dense,
                           Dropout, Embedding, Flatten, GroupNorm,
                           HybridLambda, HybridSequential, Identity,
                           InstanceNorm, Lambda, LayerNorm, LeakyReLU, PReLU,
                           Sequential, SiLU, Swish)
from .conv_layers import (AvgPool1D, AvgPool2D, AvgPool3D, Conv1D, Conv2D,
                          Conv3D, GlobalAvgPool1D, GlobalAvgPool2D,
                          GlobalAvgPool3D, GlobalMaxPool1D, GlobalMaxPool2D,
                          GlobalMaxPool3D, MaxPool1D, MaxPool2D, MaxPool3D)
from .transformer import (MultiHeadAttention, PositionwiseFFN,
                          TransformerEncoder, TransformerEncoderCell)

__all__ = ["ELU", "GELU", "SELU", "Activation", "AvgPool1D", "AvgPool2D", "AvgPool3D", "BatchNorm",
           "Block", "Conv1D", "Conv2D", "Conv3D", "Dense", "Dropout",
           "Embedding", "Flatten", "GlobalAvgPool1D", "GlobalAvgPool2D",
           "GlobalAvgPool3D", "GlobalMaxPool1D", "GlobalMaxPool2D",
           "GlobalMaxPool3D", "GroupNorm", "HybridBlock", "HybridLambda",
           "HybridSequential", "Identity", "InstanceNorm", "Lambda",
           "LayerNorm", "LeakyReLU", "MaxPool1D", "MaxPool2D", "MaxPool3D",
           "MultiHeadAttention", "PReLU", "PositionwiseFFN", "SiLU",
           "Sequential", "Swish", "TransformerEncoder",
           "TransformerEncoderCell"]
