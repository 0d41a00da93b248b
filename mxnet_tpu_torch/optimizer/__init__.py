"""Optimizers of the PyTorch port (``mxnet_tpu/optimizer``'s
counterpart)."""
from __future__ import annotations

from .optimizer import (DCASGD, LAMB, LBSGD, NAG, SGD, SGLD, AdaDelta,
                        AdaGrad, Adam, AdamW, Ftrl, Optimizer, RMSProp,
                        Signum, Test, Updater, create, get_updater,
                        register)

__all__ = ["DCASGD", "LAMB", "LBSGD", "NAG", "SGD", "SGLD", "AdaDelta",
           "AdaGrad", "Adam", "AdamW", "Ftrl", "Optimizer", "RMSProp",
           "Signum", "Test", "Updater", "create", "get_updater",
           "register"]
