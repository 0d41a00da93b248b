"""Gluon utilities: ``split_and_load`` and ``clip_global_norm``.

Port of those functions of ``mxnet_tpu/gluon/utils.py``. One card
holds one replica, so ``split_and_load`` takes one device; more wait
for multi-GPU (ROADMAP Queue 1, 'Multi-GPU').
"""
from __future__ import annotations

import math
import warnings

import torch

from ..ndarray.ndarray import NDArray

__all__ = ["clip_global_norm", "split_and_load"]


def split_and_load(data, ctx_list, batch_axis=0, even_split=True):
    """``[data]`` on the one device of ``ctx_list`` (a device, a name
    or a list of one). ``data`` may be a tensor or an array."""
    if not isinstance(ctx_list, (list, tuple)):
        ctx_list = [ctx_list]
    if len(ctx_list) != 1:
        raise NotImplementedError(
            f"split_and_load over {len(ctx_list)} devices: multi-GPU is "
            f"not ported yet (ROADMAP Queue 1, 'Multi-GPU')")
    return [torch.as_tensor(data, device=torch.device(ctx_list[0]))]


@torch.no_grad()
def clip_global_norm(arrays, max_norm, check_isfinite=True):
    """Rescale ``arrays`` in place so that their joint L2 norm is at
    most ``max_norm``; returns that norm (before scaling) as a float.
    The norms are summed on the arrays' device and read back once: one
    host sync, not one per array."""
    if not arrays:
        raise ValueError("clip_global_norm needs at least one array")
    # NDArray views (``Parameter.grad()``) share storage with the
    # gradients: scale their plain tensors, away from the subclass's
    # dispatch
    arrays = [a.as_subclass(torch.Tensor) if isinstance(a, NDArray) else a
              for a in arrays]
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
