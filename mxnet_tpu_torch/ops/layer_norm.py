"""LayerNorm over the last axis: the CUDA kernel's wrapper and its
plain PyTorch version.

Port of ``mxnet_tpu/ops/pallas/layer_norm.py`` (forward:
``_ln_fwd`` / ``_ln_fwd_kernel``). Any leading shape is flattened to
(R, D) over the normalised last axis. The math, in float32 whatever
the input type: the mean, then the variance of the centred values
(never E[x^2] - mean^2), ``rstd = 1 / sqrt(var + eps)``, and
``y = (x - mean) * rstd * gamma + beta`` in x's type. The per-row mean
and rstd (float32) come back on request: the backward needs them.

:func:`layer_norm_fused` launches the hand-written CUDA kernel
(``csrc/layer_norm.cu``) for CUDA tensors and takes the plain version
(:func:`layer_norm_reference`) only for CPU tensors; on both it checks
the operands and raises on what the kernel does not take. Forward
only: the backward kernel comes with training.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

__all__ = ["LAUNCHES", "layer_norm_fused", "layer_norm_reference"]

#: kernel launches by kernel name (the main-path proof counts these)
LAUNCHES = {"layer_norm": 0}
_MAX_D = 1024
# mxtt_layer_norm_fwd(x, gamma, beta, y, mean, rstd, R, D, eps, dtype)
_ARGS = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 2 + [ctypes.c_float,
                                                       ctypes.c_int]


def layer_norm_reference(x, gamma, beta, eps=1e-5, return_stats=False):
    """Plain PyTorch version: ``_ln_fwd_kernel``'s math on (R, D) rows
    in float32. Returns y (x's shape and type), and with
    ``return_stats`` also (mean, rstd), each (R,) float32."""
    d = x.shape[-1]
    x2 = x.reshape(-1, d).float()
    mu = x2.mean(dim=1, keepdim=True)
    xc = x2 - mu
    var = (xc * xc).mean(dim=1, keepdim=True)
    rs = 1.0 / torch.sqrt(var + eps)
    y = (xc * rs * gamma.float() + beta.float()).to(x.dtype).reshape(x.shape)
    if return_stats:
        return y, mu.reshape(-1), rs.reshape(-1)
    return y


def _check(x, gamma, beta):
    d = x.shape[-1] if x.ndim else 0
    if x.ndim < 1 or not 1 <= d <= _MAX_D:
        raise ValueError(f"layer norm kernel takes a last axis of 1..{_MAX_D}"
                         f", got shape {tuple(x.shape)}")
    if gamma.shape != (d,) or beta.shape != (d,):
        raise ValueError(f"gamma/beta must be ({d},), got "
                         f"{tuple(gamma.shape)}/{tuple(beta.shape)}")
    if x.dtype not in _build.DTYPE_CODES or gamma.dtype != x.dtype \
            or beta.dtype != x.dtype:
        raise TypeError(f"layer norm kernel takes float32, bfloat16 or "
                        f"float16 x/gamma/beta of one dtype, got "
                        f"{x.dtype}/{gamma.dtype}/{beta.dtype}")
    devs = {t.device for t in (x, gamma, beta)}
    if len(devs) != 1:
        raise ValueError(f"layer norm operands on several devices: "
                         f"{sorted(map(str, devs))}")
    for name, t in (("x", x), ("gamma", gamma), ("beta", beta)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def layer_norm_fused(x, gamma, beta, eps=1e-5, return_stats=False):
    """LayerNorm over the last axis of ``x`` (module docstring). CUDA
    tensors launch the CUDA kernel or raise; CPU tensors take
    :func:`layer_norm_reference`. With ``return_stats`` returns
    ``(y, mean, rstd)``, the stats (R,) float32."""
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"layer norm runs on cuda or cpu tensors, got "
                         f"{x.device}")
    _check(x, gamma, beta)
    if x.device.type == "cpu":
        return layer_norm_reference(x, gamma, beta, eps, return_stats)
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (x, gamma, beta)):
        raise RuntimeError("the layer norm kernel is forward only: run it "
                           "under torch.no_grad() or inference_mode()")
    d = x.shape[-1]
    r = x.numel() // d
    y = torch.empty_like(x)
    stats = (torch.empty(r, dtype=torch.float32, device=x.device),
             torch.empty(r, dtype=torch.float32, device=x.device)) \
        if return_stats else None
    if r:
        _build.launch("layer_norm", "mxtt_layer_norm_fwd", _ARGS, x.device,
                      x.data_ptr(), gamma.data_ptr(), beta.data_ptr(),
                      y.data_ptr(), stats[0].data_ptr() if stats else None,
                      stats[1].data_ptr() if stats else None, r, d,
                      float(eps), _build.DTYPE_CODES[x.dtype])
        LAUNCHES["layer_norm"] += 1
    return (y, *stats) if return_stats else y
