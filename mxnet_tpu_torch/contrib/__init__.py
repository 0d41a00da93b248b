"""``mx.contrib``: mixed precision (``contrib.amp``), int8 quantization
(``contrib.quantization``) and TensorBoard logging
(``contrib.tensorboard``).

Port of ``mxnet_tpu/contrib/__init__.py``. ``onnx`` is not ported yet:
it raises ``NotImplementedError`` naming its ROADMAP Queue 1 item.
"""
from __future__ import annotations

from . import amp, quantization, tensorboard

__all__ = ["amp", "quantization", "tensorboard"]

_WAITING = {"onnx": "Long tail"}


def __getattr__(name):
    item = _WAITING.get(name)
    if item is not None:
        raise NotImplementedError(
            f"mx.contrib.{name} is not ported yet (ROADMAP Queue 1, "
            f"'{item}')")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
