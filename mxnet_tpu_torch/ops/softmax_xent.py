"""Fused softmax cross-entropy, forward (K4a) and backward (K4b): the
CUDA kernels' wrappers, their plain PyTorch versions, and the autograd
Function that binds the two.

Port of ``mxnet_tpu/ops/pallas/softmax_xent.py`` (``softmax_xent_fused``
over ``_xent_fwd`` / ``_xent_fwd_kernel`` and ``_xent_bwd`` /
``_xent_bwd_kernel``). For logits (N, V) and integer labels (N,)::

    lse[n]   = log sum_c exp(logits[n, c])            float32
    loss[n]  = lse[n] - logits[n, labels[n]]          float32
    dlogits  = (softmax(logits) - onehot(labels)) * g[:, None]

in float32, dlogits in the logits' type. Only ``loss`` and ``lse`` (8
bytes per row) are kept between the two passes: the (N, V) log-softmax
is never written. There is no ignore label, as on the TPU: a label
outside [0, V) picks nothing (its loss is lse); callers mask rows.

:func:`softmax_xent_fused` is one ``torch.autograd.Function``: for CUDA
tensors its forward launches K4a and its backward K4b
(``csrc/softmax_xent.cu``); for CPU tensors it takes the plain versions
(:func:`softmax_xent_reference`,
:func:`softmax_xent_backward_reference`), so the CPU tests run the same
wiring. The operands are checked, and what the kernels do not take
raises.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

__all__ = ["LAUNCHES", "softmax_xent_backward",
           "softmax_xent_backward_reference", "softmax_xent_forward",
           "softmax_xent_fused", "softmax_xent_reference"]

#: kernel launches by kernel name (the main-path proof counts these)
LAUNCHES = {"softmax_xent_fwd": 0, "softmax_xent_bwd": 0}
# mxtt_softmax_xent_fwd(x, labels, loss, lse, N, V, dtype)
_FWD_ARGS = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3
# mxtt_softmax_xent_bwd(x, labels, lse, g, dx, N, V, dtype)
_BWD_ARGS = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3


def _picked(logits, labels):
    """logits[n, labels[n]] in float32, 0 where the label is outside
    [0, V)."""
    v = logits.shape[1]
    lab = labels.to(torch.int64)
    inside = (lab >= 0) & (lab < v)
    got = logits.float().gather(1, lab.clamp(0, v - 1)[:, None])[:, 0]
    return torch.where(inside, got, torch.zeros((), device=got.device))


def softmax_xent_reference(logits, labels):
    """Plain PyTorch version of the forward in float32: ``(loss, lse)``,
    each (N,) float32."""
    x = logits.float()
    m = x.amax(dim=1, keepdim=True)
    lse = (m + torch.log(torch.exp(x - m).sum(dim=1, keepdim=True)))[:, 0]
    return lse - _picked(logits, labels), lse


def softmax_xent_backward_reference(logits, labels, lse, g):
    """Plain PyTorch version of the backward: ``(exp(logits - lse) -
    onehot) * g`` in float32, returned in the logits' type."""
    v = logits.shape[1]
    p = torch.exp(logits.float() - lse.float()[:, None])
    col = torch.arange(v, device=logits.device)
    hit = col[None, :] == labels.to(torch.int64)[:, None]
    return ((p - hit.float()) * g.float()[:, None]).to(logits.dtype)


def _check(logits, labels):
    if logits.ndim != 2 or logits.shape[1] < 1:
        raise ValueError(f"softmax cross-entropy takes (N, V) logits, got "
                         f"{tuple(logits.shape)}")
    if logits.dtype not in _build.DTYPE_CODES:
        raise TypeError(f"softmax cross-entropy takes float32, bfloat16 or "
                        f"float16 logits, got {logits.dtype}")
    if labels.shape != logits.shape[:1] or labels.dtype.is_floating_point \
            or labels.dtype.is_complex or labels.dtype == torch.bool:
        raise TypeError(f"labels must be ({logits.shape[0]},) integers, got "
                        f"{tuple(labels.shape)} {labels.dtype}")
    if labels.device != logits.device:
        raise ValueError(f"logits on {logits.device}, labels on "
                         f"{labels.device}")
    if logits.device.type not in ("cpu", "cuda", "meta"):
        raise ValueError(f"softmax cross-entropy runs on cuda or cpu "
                         f"tensors, got {logits.device}")
    if logits.shape[1] >= 2 ** 31 or logits.shape[0] >= 2 ** 31:
        raise ValueError("softmax cross-entropy: N and V must be < 2**31")


def softmax_xent_forward(logits, labels):
    """``(loss, lse)`` per row, each (N,) float32. CUDA tensors launch
    K4a or raise; CPU tensors take :func:`softmax_xent_reference`."""
    _check(logits, labels)
    if _build.plain(logits):
        return softmax_xent_reference(logits, labels)
    n, v = logits.shape
    x = logits.contiguous()
    lab = labels.to(torch.int32).contiguous()
    loss = torch.empty(n, dtype=torch.float32, device=x.device)
    lse = torch.empty(n, dtype=torch.float32, device=x.device)
    if n:
        code = _build.DTYPE_CODES[x.dtype]
        _build.launch("softmax_xent", "mxtt_softmax_xent_fwd", _FWD_ARGS,
                      x.device, x.data_ptr(), lab.data_ptr(),
                      loss.data_ptr(), lse.data_ptr(), n, v,
                      code, count=(LAUNCHES, "softmax_xent_fwd", code))
    return loss, lse


def softmax_xent_backward(logits, labels, lse, g):
    """d loss / d logits for the upstream per-row gradient ``g`` (N,),
    in the logits' type. CUDA tensors launch K4b or raise; CPU tensors
    take :func:`softmax_xent_backward_reference`."""
    _check(logits, labels)
    n = logits.shape[0]
    if lse.shape != (n,) or g.shape != (n,):
        raise ValueError(f"lse and g must be ({n},)")
    if _build.plain(logits):
        return softmax_xent_backward_reference(logits, labels, lse, g)
    v = logits.shape[1]
    x = logits.contiguous()
    lab = labels.to(torch.int32).contiguous()
    lse, g = lse.float().contiguous(), g.float().contiguous()
    dx = torch.empty_like(x)
    if n:
        code = _build.DTYPE_CODES[x.dtype]
        _build.launch("softmax_xent", "mxtt_softmax_xent_bwd", _BWD_ARGS,
                      x.device, x.data_ptr(), lab.data_ptr(),
                      lse.data_ptr(), g.data_ptr(), dx.data_ptr(), n, v,
                      code, count=(LAUNCHES, "softmax_xent_bwd", code))
    return dx


class _SoftmaxXent(torch.autograd.Function):
    """K4a forward with lse saved, K4b backward (plain versions for CPU
    tensors)."""

    @staticmethod
    def forward(ctx, logits, labels):
        loss, lse = softmax_xent_forward(logits, labels)
        ctx.save_for_backward(logits, labels, lse)
        ctx.mark_non_differentiable(lse)
        return loss, lse

    @staticmethod
    def backward(ctx, g, _):
        logits, labels, lse = ctx.saved_tensors
        return softmax_xent_backward(logits, labels, lse, g), None


def softmax_xent_fused(logits, labels):
    """Per-row ``-log softmax(logits)[labels]``, (N,) float32;
    differentiable in ``logits`` (module docstring)."""
    _check(logits, labels)
    return _SoftmaxXent.apply(logits, labels)[0]
