"""Contrib layers of the PyTorch port (``mxnet_tpu/gluon/contrib/nn``'s
counterpart)."""
from __future__ import annotations

from .basic_layers import (Concurrent, HybridConcurrent, Identity,
                           PixelShuffle2D, SparseEmbedding, SyncBatchNorm)

__all__ = ["Concurrent", "HybridConcurrent", "Identity", "PixelShuffle2D",
           "SparseEmbedding", "SyncBatchNorm"]
