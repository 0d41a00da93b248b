"""Tensor ops of the PyTorch port (``mxnet_tpu/ndarray``'s
counterpart, reduced to the neural-network ops encoder serving
calls)."""
from __future__ import annotations

from . import op_impl_nn
from .op_impl_nn import flash_attention_op, layer_norm, segment_valid_len

__all__ = ["flash_attention_op", "layer_norm", "op_impl_nn",
           "segment_valid_len"]
