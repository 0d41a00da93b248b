"""Arrays and tensor ops of the PyTorch port (``mxnet_tpu/ndarray``'s
counterpart): the ``NDArray`` type and its constructors, the ``.params``
file format (``save``/``load``), and the neural-network ops its models
call, the fused LSTM op and the optimizer updates."""
from __future__ import annotations

from . import ndarray, op_impl_nn, op_impl_optimizer, op_impl_rnn
from . import serialization
from .ndarray import (NDArray, arange, array, empty, full, ones, ones_like,
                      waitall, zeros, zeros_like)
from .op_impl_nn import (batch_norm, batch_norm_train, convolution,
                         flash_attention_op, layer_norm, log_softmax, pick,
                         pooling, relu, segment_valid_len,
                         softmax_cross_entropy)
from .op_impl_optimizer import (adam_update, adamw_update,
                                multi_sgd_mom_update, multi_sgd_update,
                                sgd_mom_update, sgd_update)
from .op_impl_rnn import rnn
from .serialization import load, load_bytes, save, save_bytes

__all__ = ["NDArray", "adam_update", "adamw_update", "arange", "array",
           "batch_norm", "batch_norm_train", "convolution", "empty",
           "flash_attention_op", "full", "layer_norm", "load",
           "load_bytes", "log_softmax", "multi_sgd_mom_update",
           "multi_sgd_update", "ndarray", "ones", "ones_like", "op_impl_nn",
           "op_impl_optimizer", "op_impl_rnn", "pick", "pooling", "relu",
           "rnn", "save", "save_bytes", "segment_valid_len",
           "serialization", "sgd_mom_update", "sgd_update",
           "softmax_cross_entropy", "waitall", "zeros", "zeros_like"]
