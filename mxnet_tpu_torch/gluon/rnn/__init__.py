"""Recurrent layers of the PyTorch port (``mxnet_tpu/gluon/rnn``'s
counterpart): the fused multi-layer ``LSTM``. The GRU and vanilla RNN
layers and the cells of ``rnn_cell.py`` are not ported yet (ROADMAP
Queue 1, 'RNN remainders')."""
from __future__ import annotations

from .rnn_layer import LSTM

__all__ = ["LSTM"]
