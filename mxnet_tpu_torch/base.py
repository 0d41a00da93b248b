"""Base error type of the PyTorch port (``mxnet_tpu/base.py``'s
counterpart, reduced to what the decode-serving slice needs)."""
from __future__ import annotations

__all__ = ["MXNetError"]


class MXNetError(RuntimeError):
    """Framework error type (analog of ``mxnet.base.MXNetError``)."""
