"""Tensor ops of the PyTorch port (``mxnet_tpu/ndarray``'s
counterpart, reduced to the neural-network ops its models call, the
fused LSTM op and the optimizer updates)."""
from __future__ import annotations

from . import op_impl_nn, op_impl_optimizer, op_impl_rnn
from .op_impl_nn import (batch_norm, batch_norm_train, convolution,
                         flash_attention_op, layer_norm, log_softmax, pick,
                         pooling, relu, segment_valid_len,
                         softmax_cross_entropy)
from .op_impl_optimizer import (adam_update, adamw_update,
                                multi_sgd_mom_update, multi_sgd_update,
                                sgd_mom_update, sgd_update)
from .op_impl_rnn import rnn

__all__ = ["adam_update", "adamw_update", "batch_norm", "batch_norm_train",
           "convolution", "flash_attention_op", "layer_norm", "log_softmax",
           "multi_sgd_mom_update", "multi_sgd_update", "op_impl_nn",
           "op_impl_optimizer", "op_impl_rnn", "pick", "pooling", "relu",
           "rnn", "segment_valid_len", "sgd_mom_update", "sgd_update",
           "softmax_cross_entropy"]
