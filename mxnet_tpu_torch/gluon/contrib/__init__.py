"""Gluon contrib of the PyTorch port (``mxnet_tpu/gluon/contrib``'s
counterpart): ``nn`` (``Concurrent``, ``PixelShuffle2D``, ...), ``rnn``
(``VariationalDropoutCell``) and ``estimator`` (``Estimator`` and its
event handlers)."""
from __future__ import annotations

from . import estimator, nn, rnn

__all__ = ["estimator", "nn", "rnn"]
