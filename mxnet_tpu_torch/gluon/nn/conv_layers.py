"""Convolution and pooling layers.

Port of ``_Conv``, ``Conv1D/2D/3D`` and the pooling layers of
``mxnet_tpu/gluon/nn/conv_layers.py`` over the ``Convolution`` and
``Pooling`` ops (``ndarray.op_impl_nn``; cuDNN on the card). The
weight is (channels, in_channels / groups, *kernel), named ``weight``,
and the bias ``bias``, as Gluon's; float32 until ``Block.cast``.
Without ``in_channels`` the weight takes its width at the first
forward (a deferred shape, ``gluon.parameter``). Layouts are
channels-first (``NCW``, ``NCHW``, ``NCDHW``) only, as the JAX layers
compute them. The transposed convolutions and ``ReflectionPad2D`` are
not ported yet (ROADMAP 'Vision remainders'). ``device=None`` is the
current context's device and raises without a card; pass
``device="cpu"`` (or use ``with mx.cpu():``) for the CPU.
"""
from __future__ import annotations

import torch

from ...context import resolve_device
from ...ndarray import op_impl_nn as _nn
from ..block import Block
from .basic_layers import Activation

__all__ = ["AvgPool1D", "AvgPool2D", "AvgPool3D", "Conv1D", "Conv2D",
           "Conv3D", "GlobalAvgPool1D", "GlobalAvgPool2D", "GlobalAvgPool3D",
           "GlobalMaxPool1D", "GlobalMaxPool2D", "GlobalMaxPool3D",
           "MaxPool1D", "MaxPool2D", "MaxPool3D"]

_LAYOUTS = {1: "NCW", 2: "NCHW", 3: "NCDHW"}


def _tup(v, n):
    if isinstance(v, int):
        return (v,) * n
    return tuple(int(x) for x in v)


class _Conv(Block):
    """``act(Convolution(x, weight, bias))``."""

    def __init__(self, channels, kernel_size, strides, padding, dilation,
                 groups, layout, in_channels=0, activation=None,
                 use_bias=True, weight_initializer=None,
                 bias_initializer="zeros", prefix=None, params=None,
                 device=None):
        super().__init__(prefix, params)
        nd_ = len(kernel_size)
        if layout != _LAYOUTS[nd_]:
            raise NotImplementedError(f"layout {layout!r}: the port's "
                                      f"convolutions are channels-first")
        self._check_groups(channels, in_channels, groups)
        dev, dt = resolve_device(device), torch.float32
        self._channels = channels
        self._in_channels = in_channels
        self._kernel = tuple(kernel_size)
        self._kwargs = {"kernel": kernel_size, "stride": strides,
                        "dilate": dilation, "pad": padding,
                        "num_group": groups}
        self.weight = self._param(
            (channels, in_channels // groups) + self._kernel, dt, dev,
            init=weight_initializer)
        self.bias = self._param((channels,), dt, dev, init=bias_initializer) \
            if use_bias else None
        self.act = (Activation(activation, prefix=activation + "_")
                    if activation is not None else None)

    @staticmethod
    def _check_groups(channels, in_channels, groups):
        if in_channels % groups or channels % groups:
            raise ValueError(f"channels {channels} and in_channels "
                             f"{in_channels} must divide by groups {groups}")

    def forward(self, x):
        if self._deferred:
            groups = self._kwargs["num_group"]
            self._in_channels = x.shape[1]
            self._check_groups(self._channels, self._in_channels, groups)
            self._finish_deferred(weight=(
                self._channels, self._in_channels // groups) + self._kernel)
        out = _nn.convolution(x, self.weight, self.bias, **self._kwargs)
        return self.act(out) if self.act is not None else out

    def extra_repr(self):
        return (f"{self._in_channels} -> {self._channels}, kernel_size="
                f"{self._kwargs['kernel']}, stride={self._kwargs['stride']}")


class Conv1D(_Conv):
    def __init__(self, channels, kernel_size, strides=1, padding=0,
                 dilation=1, groups=1, layout="NCW", activation=None,
                 use_bias=True, in_channels=0, **kwargs):
        super().__init__(channels, _tup(kernel_size, 1), _tup(strides, 1),
                         _tup(padding, 1), _tup(dilation, 1), groups, layout,
                         in_channels, activation, use_bias, **kwargs)


class Conv2D(_Conv):
    def __init__(self, channels, kernel_size, strides=(1, 1), padding=(0, 0),
                 dilation=(1, 1), groups=1, layout="NCHW", activation=None,
                 use_bias=True, in_channels=0, **kwargs):
        super().__init__(channels, _tup(kernel_size, 2), _tup(strides, 2),
                         _tup(padding, 2), _tup(dilation, 2), groups, layout,
                         in_channels, activation, use_bias, **kwargs)


class Conv3D(_Conv):
    def __init__(self, channels, kernel_size, strides=(1, 1, 1),
                 padding=(0, 0, 0), dilation=(1, 1, 1), groups=1,
                 layout="NCDHW", activation=None, use_bias=True,
                 in_channels=0, **kwargs):
        super().__init__(channels, _tup(kernel_size, 3), _tup(strides, 3),
                         _tup(padding, 3), _tup(dilation, 3), groups, layout,
                         in_channels, activation, use_bias, **kwargs)


class _Pooling(Block):
    """``Pooling`` op with fixed arguments; ``strides=None`` is the
    pool size, ``ceil_mode`` the ``"full"`` convention."""

    def __init__(self, pool_size, strides, padding, ceil_mode, global_pool,
                 pool_type, layout, count_include_pad=True, prefix=None,
                 params=None):
        super().__init__(prefix, params)
        if layout != _LAYOUTS[len(pool_size)]:
            raise NotImplementedError(f"layout {layout!r}: the port's "
                                      f"pooling is channels-first")
        self._kwargs = {
            "kernel": pool_size,
            "stride": pool_size if strides is None else strides,
            "pad": padding, "global_pool": global_pool,
            "pool_type": pool_type,
            "pooling_convention": "full" if ceil_mode else "valid",
            "count_include_pad": count_include_pad}

    def forward(self, x):
        return _nn.pooling(x, **self._kwargs)

    def extra_repr(self):
        k = self._kwargs
        return f"size={k['kernel']}, stride={k['stride']}, padding={k['pad']}"


def _pool_args(n, pool_size, strides, padding):
    return (_tup(pool_size, n), None if strides is None else
            _tup(strides, n), _tup(padding, n))


class MaxPool1D(_Pooling):
    def __init__(self, pool_size=2, strides=None, padding=0, layout="NCW",
                 ceil_mode=False, **kwargs):
        super().__init__(*_pool_args(1, pool_size, strides, padding),
                         ceil_mode, False, "max", layout, **kwargs)


class MaxPool2D(_Pooling):
    def __init__(self, pool_size=(2, 2), strides=None, padding=0,
                 layout="NCHW", ceil_mode=False, **kwargs):
        super().__init__(*_pool_args(2, pool_size, strides, padding),
                         ceil_mode, False, "max", layout, **kwargs)


class MaxPool3D(_Pooling):
    def __init__(self, pool_size=(2, 2, 2), strides=None, padding=0,
                 layout="NCDHW", ceil_mode=False, **kwargs):
        super().__init__(*_pool_args(3, pool_size, strides, padding),
                         ceil_mode, False, "max", layout, **kwargs)


class AvgPool1D(_Pooling):
    def __init__(self, pool_size=2, strides=None, padding=0, layout="NCW",
                 ceil_mode=False, count_include_pad=True, **kwargs):
        super().__init__(*_pool_args(1, pool_size, strides, padding),
                         ceil_mode, False, "avg", layout, count_include_pad,
                         **kwargs)


class AvgPool2D(_Pooling):
    def __init__(self, pool_size=(2, 2), strides=None, padding=0,
                 layout="NCHW", ceil_mode=False, count_include_pad=True,
                 **kwargs):
        super().__init__(*_pool_args(2, pool_size, strides, padding),
                         ceil_mode, False, "avg", layout, count_include_pad,
                         **kwargs)


class AvgPool3D(_Pooling):
    def __init__(self, pool_size=(2, 2, 2), strides=None, padding=0,
                 layout="NCDHW", ceil_mode=False, count_include_pad=True,
                 **kwargs):
        super().__init__(*_pool_args(3, pool_size, strides, padding),
                         ceil_mode, False, "avg", layout, count_include_pad,
                         **kwargs)


class GlobalMaxPool1D(_Pooling):
    def __init__(self, layout="NCW", **kwargs):
        super().__init__((1,), None, (0,), True, True, "max", layout,
                         **kwargs)


class GlobalMaxPool2D(_Pooling):
    def __init__(self, layout="NCHW", **kwargs):
        super().__init__((1, 1), None, (0, 0), True, True, "max", layout,
                         **kwargs)


class GlobalMaxPool3D(_Pooling):
    def __init__(self, layout="NCDHW", **kwargs):
        super().__init__((1, 1, 1), None, (0, 0, 0), True, True, "max",
                         layout, **kwargs)


class GlobalAvgPool1D(_Pooling):
    def __init__(self, layout="NCW", **kwargs):
        super().__init__((1,), None, (0,), True, True, "avg", layout,
                         **kwargs)


class GlobalAvgPool2D(_Pooling):
    def __init__(self, layout="NCHW", **kwargs):
        super().__init__((1, 1), None, (0, 0), True, True, "avg", layout,
                         **kwargs)


class GlobalAvgPool3D(_Pooling):
    def __init__(self, layout="NCDHW", **kwargs):
        super().__init__((1, 1, 1), None, (0, 0, 0), True, True, "avg",
                         layout, **kwargs)
