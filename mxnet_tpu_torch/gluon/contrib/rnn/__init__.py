"""Contrib recurrent cells of the PyTorch port
(``mxnet_tpu/gluon/contrib/rnn``'s counterpart)."""
from __future__ import annotations

from .rnn_cell import VariationalDropoutCell

__all__ = ["VariationalDropoutCell"]
