"""INT8 quantized compute operators.

Port of ``mxnet_tpu/ndarray/op_impl_quant.py`` (the reference's
``src/operator/quantization/``: quantize_v2, dequantize,
quantized_fully_connected, quantized_conv): symmetric, zero-point-free
int8, ``q = round(clip(x / s, +-127))`` with ``s = amax / 127``
(``round`` half to even, as ``jnp.round``).

The products run on int8 operands into exact int32 sums, as the JAX
ops ask XLA for (``preferred_element_type=int32``): :func:`int8_gemm`
is ``torch._int_mm`` (cuBLASLt's s8 x s8 -> s32 GEMM on the card,
torch's own on the CPU), the convolution its im2col (strided views of
the zero-padded int8 input, one copy into the column matrix). On the
card cuBLASLt takes more than 16 rows and inner and output widths that
are multiples of 8: the operands are zero-padded to that, which leaves
every sum as it is. A float32 convolution would not be exact
(127^2 x 4608 exceeds 2^24).

Bits at the boundary: every scale stays a device tensor and every
division is tensor by tensor (CUDA divides by a host scalar through
its reciprocal, which can move a quantized value by one step), so the
card and the CPU give the same codes; a dynamic range (``amax <= 0``)
is picked on the device (``torch.where``), with no host read, so a
hybridized quantized block captures as a CUDA graph.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .register import register_op

__all__ = ["dequantize_v2", "int8_conv", "int8_gemm", "quantize_act",
           "quantize_v2", "quantize_weight", "quantized_conv",
           "quantized_fully_connected"]

_QMAX = 127.0


def _amax_scale(amax):
    a = torch.clamp_min(amax.to(torch.float32), 1e-8)
    return a / torch.full((), _QMAX, dtype=torch.float32, device=a.device)


def _quantize(x, s):
    """``clip(round(x / s), +-127)`` as int8; ``x`` in at least float32
    (the JAX division promotes a bfloat16 ``x`` by the float32 scale)."""
    x = x.to(torch.promote_types(x.dtype, torch.float32))
    return torch.clamp(torch.round(x / s), -_QMAX, _QMAX).to(torch.int8)


def _round_up(n, m):
    return -(-n // m) * m


def int8_gemm(a, b):
    """``a @ b.T`` of int8 ``a`` (M, K) and ``b`` (N, K) as exact int32
    sums (M, N). On the card both operands are zero-padded to cuBLASLt's
    shapes (M > 16, K and N multiples of 8) and the result cut back."""
    m, k = a.shape
    n = b.shape[0]
    if a.device.type != "cuda":
        return torch._int_mm(a, b.t())
    mp, kp, np_ = max(m, 17), _round_up(k, 8), _round_up(n, 8)
    if (mp, kp) != (m, k):
        a = F.pad(a, (0, kp - k, 0, mp - m))
    if (np_, kp) != (n, k):
        b = F.pad(b, (0, kp - k, 0, np_ - n))
    out = torch._int_mm(a.contiguous(), b.contiguous().t())
    return out[:m, :n] if (mp, np_) != (m, n) else out


def int8_conv(data, weight, stride, pad, dilate, groups):
    """Exact int32 convolution of int8 (N, C, *spatial) ``data`` with
    int8 (O, C / groups, *kernel) ``weight``: the zero-padded input's
    windows (``Tensor.unfold`` views, every ``dilate``-th tap) copied
    into an (N * out positions, C / groups * taps) matrix a group, and
    :func:`int8_gemm` with the weight's rows."""
    nd_ = weight.ndim - 2
    kernel = tuple(weight.shape[2:])
    x = F.pad(data, tuple(p for d in reversed(range(nd_))
                          for p in (pad[d], pad[d])))
    for d in range(nd_):
        x = x.unfold(2 + d, dilate[d] * (kernel[d] - 1) + 1, stride[d])
    if any(v != 1 for v in dilate):
        x = x[(Ellipsis,) + tuple(slice(None, None, v) for v in dilate)]
    n, c = data.shape[:2]
    outs = tuple(x.shape[2:2 + nd_])
    o = weight.shape[0]
    g = int(groups)
    # (N, g, C/g, *out, *k) -> (g, N, *out, C/g, *k)
    x = x.reshape((n, g, c // g) + outs + kernel)
    perm = (1, 0) + tuple(range(3, 3 + nd_)) + (2,) + \
        tuple(range(3 + nd_, 3 + 2 * nd_))
    cols = x.permute(perm).reshape(g, n * math.prod(outs), -1)
    w = weight.reshape(g, o // g, -1)
    acc = torch.cat([int8_gemm(cols[i], w[i]) for i in range(g)], dim=1) \
        if g > 1 else int8_gemm(cols[0], w[0])
    # (N * out, O) -> (N, O, *out)
    acc = acc.reshape((n,) + outs + (o,))
    return acc.permute((0, nd_ + 1) + tuple(range(1, nd_ + 1)))


@register_op("quantize_v2", differentiable=False, num_visible_outputs=3)
def quantize_v2(data, min_calib_range=None, max_calib_range=None,
                out_type="int8"):
    """Symmetric int8 quantization: ``(q, -amax, amax)``; ``amax`` the
    calibrated range, or the tensor's own without one (dynamic)."""
    if min_calib_range is not None or max_calib_range is not None:
        amax = torch.tensor(max(abs(min_calib_range or 0.0),
                                abs(max_calib_range or 0.0)),
                            dtype=torch.float32, device=data.device)
    else:
        amax = data.abs().amax().to(torch.float32)
    q = _quantize(data, _amax_scale(amax))
    ones = torch.ones(1, dtype=torch.float32, device=data.device)
    return q, -amax * ones, amax * ones


@register_op("dequantize_v2", differentiable=False)
def dequantize_v2(data, min_range, max_range, out_type="float32"):
    amax = torch.maximum(min_range.abs(), max_range.abs()).reshape(())
    return data.to(torch.float32) * _amax_scale(amax)


@register_op("quantized_fully_connected", differentiable=False)
def quantized_fully_connected(data, weight, x_scale, w_scale, bias=None,
                              num_hidden=None, flatten=True, no_bias=False):
    """int8 FullyConnected: exact int32 sums of the int8 operands times
    the two scales, the float32 bias added after."""
    x = data.reshape(data.shape[0], -1) if flatten and data.ndim > 2 \
        else data
    lead = x.shape[:-1]
    acc = int8_gemm(x.reshape(-1, x.shape[-1]), weight)
    acc = acc.reshape(lead + (weight.shape[0],))
    out = acc.to(torch.float32) * (x_scale.reshape(()) *
                                   w_scale.reshape(()))
    if bias is not None and not no_bias:
        out = out + bias
    return out


@register_op("quantized_conv", differentiable=False)
def quantized_conv(data, weight, x_scale, w_scale, bias=None, out_amax=None,
                   kernel=None, stride=None, dilate=None, pad=None,
                   num_filter=None, num_group=1, no_bias=False, layout=None):
    """int8 channels-first convolution: exact int32 sums times the
    input's scale and the weight's (per tensor, or per output channel
    for BatchNorm-folded weights); with ``out_amax`` (a (1,) calibrated
    range) the result is requantized to int8 at that range, for a
    chained int8 consumer."""
    nd_ = len(kernel) if kernel is not None else weight.ndim - 2
    stride = tuple(stride) if stride else (1,) * nd_
    dilate = tuple(dilate) if dilate else (1,) * nd_
    pad = tuple(pad) if pad else (0,) * nd_
    acc = int8_conv(data, weight, stride, pad, dilate, num_group)
    ws = w_scale.reshape(()) if w_scale.numel() == 1 else \
        w_scale.reshape((1, -1) + (1,) * nd_)
    out = acc.to(torch.float32) * x_scale.reshape(()) * ws
    if bias is not None and not no_bias:
        out = out + bias.reshape((1, -1) + (1,) * nd_)
    if out_amax is not None:
        return _quantize(out, _amax_scale(out_amax.reshape(())))
    return out


def quantize_weight(w, channelwise=False):
    """Symmetric int8 weights: ``(q, scale)``; with ``channelwise`` a
    scale an output channel (axis 0), as BatchNorm-folded convolution
    weights need."""
    if channelwise:
        amax = w.abs().amax(dim=tuple(range(1, w.ndim)))
        s = _amax_scale(amax)
        q = _quantize(w, s.reshape((-1,) + (1,) * (w.ndim - 1)))
        return q, s
    s = _amax_scale(w.abs().amax())
    return _quantize(w, s), s.reshape(1)


def quantize_act(x, amax=None):
    """Activations as int8: ``(q, scale)``. ``amax`` is None (the
    tensor's own range), a number, or a (1,) tensor whose value <= 0
    picks the tensor's own range, on the device."""
    if amax is None:
        a = x.abs().amax().to(torch.float32)
    else:
        cal = torch.as_tensor(amax, dtype=torch.float32,
                              device=x.device).reshape(())
        a = torch.where(cal > 0, cal, x.abs().to(torch.float32).amax())
    s = _amax_scale(a)
    return _quantize(x, s), s.reshape(1)
