"""Tensor ops of the PyTorch port (``mxnet_tpu/ndarray``'s
counterpart, reduced to the neural-network ops BERT serving and
training call and the optimizer updates)."""
from __future__ import annotations

from . import op_impl_nn, op_impl_optimizer
from .op_impl_nn import (flash_attention_op, layer_norm, log_softmax, pick,
                         segment_valid_len, softmax_cross_entropy)
from .op_impl_optimizer import (adam_update, adamw_update,
                                multi_sgd_mom_update, multi_sgd_update,
                                sgd_mom_update, sgd_update)

__all__ = ["adam_update", "adamw_update", "flash_attention_op",
           "layer_norm", "log_softmax", "multi_sgd_mom_update",
           "multi_sgd_update", "op_impl_nn", "op_impl_optimizer", "pick",
           "segment_valid_len", "sgd_mom_update", "sgd_update",
           "softmax_cross_entropy"]
