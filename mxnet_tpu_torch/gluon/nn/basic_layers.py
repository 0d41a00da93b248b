"""Basic layers: Dense, Embedding, LayerNorm, Dropout, Activation.

Port of the layers of ``mxnet_tpu/gluon/nn/basic_layers.py`` that BERT
uses, as ``nn.Module``s with Gluon's parameter names and layouts
(Dense's weight is (units, in_units), as ``nn.Linear``'s). Shapes are
given at construction (``in_units``, ``in_channels``): the port has no
deferred initialization. ``device=None`` is the current CUDA device
and raises without one; pass ``device="cpu"`` for the CPU.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ...context import resolve_device
from ...ndarray import op_impl_nn as _nn
from ..block import Block

__all__ = ["Activation", "Dense", "Dropout", "Embedding", "LayerNorm"]


def _dtype(dtype):
    return getattr(torch, dtype) if isinstance(dtype, str) else dtype


class Dense(Block):
    """Fully-connected layer: ``act(x @ weight.T + bias)``. With
    ``flatten`` the input is first reshaped to (batch, -1)."""

    def __init__(self, units, activation=None, use_bias=True, flatten=True,
                 dtype="float32", in_units=0, prefix="", device=None):
        super().__init__(prefix)
        if in_units < 1:
            raise ValueError("Dense needs in_units (the port has no "
                             "deferred shapes)")
        dev, dt = resolve_device(device), _dtype(dtype)
        self._units = int(units)
        self._flatten = flatten
        self.weight = self._param((units, in_units), dt, dev)
        self.bias = self._param((units,), dt, dev) if use_bias else None
        self.act = (Activation(activation, prefix=activation + "_")
                    if activation is not None else None)

    def forward(self, x):
        if self._flatten:
            x = x.reshape(x.shape[0], -1)
        out = F.linear(x, self.weight, self.bias)
        return self.act(out) if self.act is not None else out


class Embedding(Block):
    """Lookup table (input_dim, output_dim); out-of-range ids clip."""

    def __init__(self, input_dim, output_dim, dtype="float32", prefix="",
                 device=None):
        super().__init__(prefix)
        self.weight = self._param((input_dim, output_dim), _dtype(dtype),
                                  resolve_device(device))

    def forward(self, x):
        return _nn.embedding(x, self.weight)


class LayerNorm(Block):
    """LayerNorm over ``axis``; the last axis runs the fused kernel."""

    def __init__(self, axis=-1, epsilon=1e-5, in_channels=0,
                 dtype="float32", prefix="", device=None):
        super().__init__(prefix)
        if in_channels < 1:
            raise ValueError("LayerNorm needs in_channels (the port has no "
                             "deferred shapes)")
        dev, dt = resolve_device(device), _dtype(dtype)
        self._axis = axis
        self._epsilon = epsilon
        self.gamma = self._param((in_channels,), dt, dev, fill=1.0)
        self.beta = self._param((in_channels,), dt, dev)

    def forward(self, x):
        return _nn.layer_norm(x, self.gamma, self.beta, axis=self._axis,
                              eps=self._epsilon)


class Dropout(Block):
    """Dropout in training mode; the identity otherwise."""

    def __init__(self, rate, prefix=""):
        super().__init__(prefix)
        self._rate = float(rate)

    def forward(self, x):
        if self.training and self._rate > 0:
            return F.dropout(x, self._rate, training=True)
        return x


class Activation(Block):
    """``Activation`` op by name (``ndarray.op_impl_nn.activation``)."""

    def __init__(self, activation, prefix=""):
        super().__init__(prefix)
        if activation not in _nn._ACT:
            raise ValueError(f"unknown activation {activation!r}")
        self._act_type = activation

    def forward(self, x):
        return _nn.activation(x, self._act_type)
