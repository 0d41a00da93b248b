"""``mx.contrib``: int8 quantization (``contrib.quantization``).

Port of ``mxnet_tpu/contrib/__init__.py``. ``amp``, ``tensorboard`` and
``onnx`` are not ported yet: each raises ``NotImplementedError`` naming
its ROADMAP Queue 1 item.
"""
from __future__ import annotations

from . import quantization

__all__ = ["quantization"]

_WAITING = {"amp": "Training extras", "tensorboard": "Long tail",
            "onnx": "Long tail"}


def __getattr__(name):
    item = _WAITING.get(name)
    if item is not None:
        raise NotImplementedError(
            f"mx.contrib.{name} is not ported yet (ROADMAP Queue 1, "
            f"'{item}')")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
