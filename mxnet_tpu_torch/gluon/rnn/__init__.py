"""Recurrent layers and cells of the PyTorch port
(``mxnet_tpu/gluon/rnn``'s counterpart): the fused multi-layer ``RNN``,
``LSTM`` and ``GRU`` (``rnn_layer``) and the step-at-a-time cells with
``unroll`` (``rnn_cell``)."""
from __future__ import annotations

from .rnn_cell import (BidirectionalCell, DropoutCell, GRUCell,
                       HybridRecurrentCell, LSTMCell, ModifierCell, RNNCell,
                       RecurrentCell, ResidualCell, SequentialRNNCell,
                       ZoneoutCell)
from .rnn_layer import GRU, LSTM, RNN

__all__ = ["GRU", "LSTM", "RNN", "BidirectionalCell", "DropoutCell",
           "GRUCell", "HybridRecurrentCell", "LSTMCell", "ModifierCell",
           "RNNCell", "RecurrentCell", "ResidualCell", "SequentialRNNCell",
           "ZoneoutCell"]
