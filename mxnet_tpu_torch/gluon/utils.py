"""Gluon utilities: ``clip_global_norm``.

Port of that function of ``mxnet_tpu/gluon/utils.py``.
"""
from __future__ import annotations

import math
import warnings

import torch

__all__ = ["clip_global_norm"]


@torch.no_grad()
def clip_global_norm(arrays, max_norm, check_isfinite=True):
    """Rescale ``arrays`` in place so that their joint L2 norm is at
    most ``max_norm``; returns that norm (before scaling) as a float.
    The norms are summed on the arrays' device and read back once: one
    host sync, not one per array."""
    if not arrays:
        raise ValueError("clip_global_norm needs at least one array")
    norms = torch.stack([a.detach().float().norm() for a in arrays])
    total = math.sqrt(float((norms * norms).sum().item()))
    if check_isfinite and not math.isfinite(total):
        warnings.warn("nan or inf is detected. Clipping results will be "
                      "undefined.", stacklevel=2)
    scale = max_norm / (total + 1e-8)
    if scale < 1.0:
        for a in arrays:
            a.mul_(scale)
    return total
