"""Gluon contrib of the PyTorch port (``mxnet_tpu/gluon/contrib``'s
counterpart): ``rnn`` (``VariationalDropoutCell``). The JAX package's
``nn`` and ``estimator`` submodules are not ported yet (ROADMAP Queue
1, 'Training extras')."""
from __future__ import annotations

from . import rnn

__all__ = ["rnn"]
