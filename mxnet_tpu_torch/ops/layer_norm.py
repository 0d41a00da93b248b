"""LayerNorm over the last axis, forward (K3a) and backward (K3b): the
CUDA kernels' wrappers, their plain PyTorch versions, and the autograd
Function that binds the two.

Port of ``mxnet_tpu/ops/pallas/layer_norm.py`` (``_ln_fwd`` /
``_ln_fwd_kernel`` and ``_ln_bwd`` / ``_ln_bwd_kernel``). Any leading
shape is flattened to (R, D) over the normalised last axis. The math,
in float32 whatever the input type: the mean, then the variance of the
centred values (never E[x^2] - mean^2), ``rstd = 1 / sqrt(var + eps)``,
and ``y = (x - mean) * rstd * gamma + beta`` in x's type. The per-row
mean and rstd (float32) come back on request: the backward needs them.

The backward, from the saved mean and rstd: ``dx = rstd * (dxhat -
mean(dxhat) - xhat * mean(dxhat * xhat))`` with ``dxhat = dy * gamma``,
and dgamma, dbeta summed over the rows in float32.

:func:`layer_norm_fused` is differentiable: one
``torch.autograd.Function`` whose forward is K3a with the stats saved
and whose backward is K3b (``csrc/layer_norm.cu`` holds both). CUDA
tensors launch the kernels; CPU tensors take the plain versions
(:func:`layer_norm_reference`, :func:`layer_norm_backward_reference`),
so the CPU tests run the same wiring. The operands are checked, and
what the kernels do not take raises.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

__all__ = ["LAUNCHES", "kernel_takes", "layer_norm_backward",
           "layer_norm_backward_reference", "layer_norm_fused",
           "layer_norm_reference"]

#: kernel launches by kernel name (the main-path proof counts these)
LAUNCHES = {"layer_norm": 0, "layer_norm_bwd": 0}
#: the widest row one warp holds (wider rows take a block each)
_WARP_D = 1024
# mxtt_layer_norm_fwd(x, gamma, beta, y, mean, rstd, R, D, eps, dtype)
_ARGS = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 2 + [ctypes.c_float,
                                                       ctypes.c_int]
# mxtt_layer_norm_bwd(x, gamma, mean, rstd, dy, dx, part, dgb, R, D,
#                     blocks, dtype)
_BWD_ARGS = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 4
#: the backward's row blocks at most (each writes one row of dgamma and
#: dbeta partials; a fixed cap keeps the sum's order fixed)
_BWD_BLOCKS = 512
_WARPS_PER_BLOCK = 8


def kernel_takes(x):
    """Whether the kernels take ``x``, from its shape and type alone: a
    last axis of at least 1, float32, bfloat16 or float16. The op calls
    it before any launch, as the JAX op tests its kernel's types."""
    return x.ndim >= 1 and x.dtype in _build.DTYPE_CODES \
        and x.shape[-1] >= 1


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


def layer_norm_backward_reference(x, gamma, mean, rstd, dy):
    """Plain PyTorch version of the backward: ``_ln_bwd_kernel``'s math
    on (R, D) rows in float32 from the saved (R,) mean and rstd.
    Returns dx (x's shape and type) and dgamma, dbeta ((D,) float32)."""
    d = x.shape[-1]
    x2, dy2 = x.reshape(-1, d).float(), dy.reshape(-1, d).float()
    mu, rs = mean.reshape(-1, 1).float(), rstd.reshape(-1, 1).float()
    xhat = (x2 - mu) * rs
    dxhat = dy2 * gamma.float()
    m1 = dxhat.mean(dim=1, keepdim=True)
    m2 = (dxhat * xhat).mean(dim=1, keepdim=True)
    dx = (rs * (dxhat - m1 - xhat * m2)).to(x.dtype).reshape(x.shape)
    return dx, (dy2 * xhat).sum(dim=0), dy2.sum(dim=0)


def _check(x, gamma, beta):
    """Raise on what the kernels do not take. Written for the call that
    passes: each test is one comparison, and the messages are built
    only on the way out (K3a runs 25 times a BERT forward)."""
    shape = x.shape
    d = shape[-1] if shape else 0
    if d < 1:
        raise ValueError(f"layer norm kernel takes a last axis of at least "
                         f"1, got shape {tuple(shape)}")
    if gamma.shape != (d,) or beta.shape != (d,):
        raise ValueError(f"gamma/beta must be ({d},), got "
                         f"{tuple(gamma.shape)}/{tuple(beta.shape)}")
    dtype = x.dtype
    if gamma.dtype != dtype or beta.dtype != dtype \
            or dtype not in _build.DTYPE_CODES:
        raise TypeError(f"layer norm kernel takes float32, bfloat16 or "
                        f"float16 x/gamma/beta of one dtype, got "
                        f"{dtype}/{gamma.dtype}/{beta.dtype}")
    dev = x.device
    if gamma.device != dev or beta.device != dev:
        devs = {t.device for t in (x, gamma, beta)}
        raise ValueError(f"layer norm operands on several devices: "
                         f"{sorted(map(str, devs))}")
    if not (x.is_contiguous() and gamma.is_contiguous()
            and beta.is_contiguous()):
        name = next(n for n, t in (("x", x), ("gamma", gamma),
                                   ("beta", beta)) if not t.is_contiguous())
        raise ValueError(f"{name} must be contiguous")


def _forward(x, gamma, beta, eps, return_stats):
    """K3a (CPU tensors: the plain version)."""
    dev = x.device
    if _build.plain(x):
        return layer_norm_reference(x, gamma, beta, eps, return_stats)
    d = x.shape[-1]
    r = x.numel() // d
    y = torch.empty_like(x)
    stats = (torch.empty(r, dtype=torch.float32, device=dev),
             torch.empty(r, dtype=torch.float32, device=dev)) \
        if return_stats else None
    if r:
        _build.launch("layer_norm", "mxtt_layer_norm_fwd", _ARGS, dev,
                      x.data_ptr(), gamma.data_ptr(), beta.data_ptr(),
                      y.data_ptr(), stats[0].data_ptr() if stats else None,
                      stats[1].data_ptr() if stats else None, r, d,
                      float(eps), _build.DTYPE_CODES[x.dtype],
                      count=(LAUNCHES, "layer_norm"))
    return (y, *stats) if return_stats else y


def layer_norm_backward(x, gamma, mean, rstd, dy):
    """dx, dgamma, dbeta of the last-axis LayerNorm from the forward's
    (R,) float32 mean and rstd. CUDA tensors launch K3b or raise; CPU
    tensors take :func:`layer_norm_backward_reference`. dgamma and
    dbeta are (D,) float32: summed per block, then over the blocks in a
    second pass (no atomics, the same sum every run)."""
    _check(x, gamma, gamma)
    d = x.shape[-1]
    r = x.numel() // d
    if dy.shape != x.shape or dy.dtype != x.dtype:
        raise ValueError(f"dy must be {tuple(x.shape)} {x.dtype}, got "
                         f"{tuple(dy.shape)} {dy.dtype}")
    if mean.shape != (r,) or rstd.shape != (r,) \
            or mean.dtype != torch.float32 or rstd.dtype != torch.float32:
        raise TypeError(f"mean/rstd must be ({r},) float32")
    if _build.plain(x):
        return layer_norm_backward_reference(x, gamma, mean, rstd, dy)
    dy = dy.contiguous()
    dx = torch.empty_like(x)
    # the fold writes every column; no rows leave the sums at zero
    dgb = (torch.empty if r else torch.zeros)((2, d), dtype=torch.float32,
                                             device=x.device)
    if r:
        # a warp a row up to _WARP_D, a block a row past it
        rows_a_block = _WARPS_PER_BLOCK if d <= _WARP_D else 1
        blocks = min(_BWD_BLOCKS, -(-r // rows_a_block))
        part = torch.empty((2, blocks, d), dtype=torch.float32,
                           device=x.device)
        _build.launch("layer_norm", "mxtt_layer_norm_bwd", _BWD_ARGS,
                      x.device, x.data_ptr(), gamma.data_ptr(),
                      mean.data_ptr(), rstd.data_ptr(), dy.data_ptr(),
                      dx.data_ptr(), part.data_ptr(), dgb.data_ptr(), r, d,
                      blocks, _build.DTYPE_CODES[x.dtype],
                      count=(LAUNCHES, "layer_norm_bwd"))
    return dx, dgb[0], dgb[1]


class _LayerNorm(torch.autograd.Function):
    """K3a forward with the stats saved, K3b backward (plain versions
    for CPU tensors)."""

    @staticmethod
    def forward(ctx, x, gamma, beta, eps):
        y, mean, rstd = _forward(x, gamma, beta, eps, True)
        ctx.save_for_backward(x, gamma, mean, rstd)
        return y

    @staticmethod
    def backward(ctx, dy):
        x, gamma, mean, rstd = ctx.saved_tensors
        dx, dg, db = layer_norm_backward(x, gamma, mean, rstd, dy)
        return dx, dg.to(gamma.dtype), db.to(gamma.dtype), None


def layer_norm_fused(x, gamma, beta, eps=1e-5, return_stats=False):
    """LayerNorm over the last axis of ``x`` (module docstring),
    differentiable in x, gamma and beta. CUDA tensors launch the CUDA
    kernels or raise; CPU tensors take the plain versions. With
    ``return_stats`` returns ``(y, mean, rstd)``, the stats (R,)
    float32; that form is forward only."""
    if x.device.type not in ("cpu", "cuda", "meta"):
        raise ValueError(f"layer norm runs on cuda or cpu tensors, got "
                         f"{x.device}")
    _check(x, gamma, beta)
    if not return_stats:
        if torch.is_grad_enabled() and (x.requires_grad
                                        or gamma.requires_grad
                                        or beta.requires_grad):
            return _LayerNorm.apply(x, gamma, beta, float(eps))
        # nothing to differentiate (serving): no graph node, no stats
        return _forward(x, gamma, beta, eps, False)
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (x, gamma, beta)):
        raise RuntimeError("layer_norm_fused(return_stats=True) is forward "
                           "only: run it under torch.no_grad()")
    return _forward(x, gamma, beta, eps, True)
