"""Runtime feature detection (``mx.runtime.Features``).

Port of ``mxnet_tpu/runtime.py``: the same twelve keys, detected
through torch. ``CUDA`` is ``torch.cuda.is_available()`` and ``CUDNN``
``torch.backends.cudnn.is_available()``; ``TPU``, ``XLA`` and
``PALLAS`` are false (the port runs no XLA and no Pallas kernel: its
kernels are hand-written CUDA), and ``DIST_KVSTORE`` is false, since
the port's ``kvstore`` raises for the ``dist_*`` modes. The other keys
keep the JAX package's values.
"""
from __future__ import annotations

import torch

__all__ = ["Feature", "Features", "feature_list"]


class Feature:
    def __init__(self, name, enabled):
        self.name = name
        self.enabled = enabled

    def __repr__(self):
        return f"[{'✔' if self.enabled else '✖'} {self.name}]"


def _detect():
    cuda = torch.cuda.is_available()
    feats = {
        "TPU": False,
        "CUDA": cuda,
        "CUDNN": cuda and torch.backends.cudnn.is_available(),
        "XLA": False,
        "PALLAS": False,
        "BLAS_OPEN": True,
        "DIST_KVSTORE": False,
        "INT64_TENSOR_SIZE": True,
        "SIGNAL_HANDLER": False,
        "MKLDNN": False,
        "OPENCV": False,
        "F16C": True,
    }
    return {k: Feature(k, v) for k, v in feats.items()}


class Features(dict):
    def __init__(self):
        super().__init__(_detect())

    def is_enabled(self, name):
        return self[name].enabled


def feature_list():
    return list(Features().values())
