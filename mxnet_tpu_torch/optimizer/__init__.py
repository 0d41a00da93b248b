"""Optimizers of the PyTorch port (``mxnet_tpu/optimizer``'s
counterpart)."""
from __future__ import annotations

from .optimizer import (SGD, AdaGrad, Adam, AdamW, Optimizer, Updater,
                        create, get_updater, register)

__all__ = ["AdaGrad", "Adam", "AdamW", "Optimizer", "SGD", "Updater",
           "create", "get_updater", "register"]
