"""``mx.rnn``: the legacy symbolic RNN cells (port of ``mxnet_tpu/rnn/``,
MXNet's ``python/mxnet/rnn/rnn_cell.py``).

Pre-Gluon cells that build SYMBOL graphs — the API behind the
reference's bucketing examples (example/rnn/bucketing with
BucketingModule). Gluon models should use ``gluon.rnn``; this namespace
exists so reference scripts using ``mx.rnn.LSTMCell(...).unroll(...)``
port unchanged.
"""
from .rnn_cell import (BaseRNNCell, RNNCell, LSTMCell, GRUCell,
                       SequentialRNNCell, DropoutCell, RNNParams,
                       ModifierCell, ResidualCell, BidirectionalCell)

__all__ = ["BaseRNNCell", "RNNCell", "LSTMCell", "GRUCell",
           "SequentialRNNCell", "DropoutCell", "RNNParams",
           "ModifierCell", "ResidualCell", "BidirectionalCell"]
