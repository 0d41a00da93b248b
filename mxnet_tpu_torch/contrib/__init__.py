"""``mx.contrib``: mixed precision (``contrib.amp``), int8 quantization
(``contrib.quantization``), TensorBoard logging
(``contrib.tensorboard``) and ONNX export/import (``contrib.onnx``).

Port of ``mxnet_tpu/contrib/__init__.py``.
"""
from __future__ import annotations

from . import amp, onnx, quantization, tensorboard

__all__ = ["amp", "onnx", "quantization", "tensorboard"]
