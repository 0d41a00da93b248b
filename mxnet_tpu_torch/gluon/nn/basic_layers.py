"""Basic layers: Sequential, HybridSequential, Dense, Embedding,
BatchNorm, LayerNorm, Dropout, Activation, Flatten, Identity, Lambda,
HybridLambda.

Port of those layers of ``mxnet_tpu/gluon/nn/basic_layers.py``, as
``nn.Module``s with Gluon's parameter names, layouts and arguments
(Dense's weight is (units, in_units), as ``nn.Linear``'s; the
``*_initializer`` arguments are each parameter's own initializer).
Input widths may be left out (``in_units``, ``in_channels``): the
weights are then deferred and take their shapes at the first forward
(``gluon.parameter``). ``Embedding`` keeps its given widths, as in
the reference. A child's prefix comes from the parent's
``name_scope`` or is given (``gluon.block``). All are differentiable
inside ``autograd.record()``: Dense and Embedding through torch's own
gradients (the embedding keeps its clamping gather), LayerNorm through
the K3a/K3b Function, BatchNorm through the JAX op's own backward
(``op_impl_nn.batch_norm_train``). ``Dropout`` drops and ``BatchNorm``
takes batch statistics only in train mode (``autograd.is_training()``).
``device=None`` is the current context's device (the card unless a
``with mx.cpu():`` scope is active) and raises without a card.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ... import autograd, ndarray
from ...context import resolve_device
from ...ndarray import op_impl_nn as _nn
from ..block import Block

__all__ = ["Activation", "BatchNorm", "Dense", "Dropout", "Embedding",
           "Flatten", "HybridLambda", "HybridSequential", "Identity",
           "Lambda", "LayerNorm", "Sequential"]


def _dtype(dtype):
    return getattr(torch, dtype) if isinstance(dtype, str) else dtype


class Sequential(Block):
    """Children run in the order added. Each keeps the Gluon prefix it
    was made with (``nn.Dense(..., prefix="dense0_")``, or one from a
    name scope)."""

    def __init__(self, prefix=None, params=None):
        super().__init__(prefix, params)

    def add(self, *blocks):
        for block in blocks:
            self.add_module(str(len(self._modules)), block)
        return self

    def forward(self, x, *args):
        for block in self._modules.values():
            x = block(x)
        return x

    def __getitem__(self, key):
        layers = list(self._modules.values())[key]
        if isinstance(layers, list):
            return type(self)(prefix=self._prefix).add(*layers)
        return layers

    def __len__(self):
        return len(self._modules)

    def __iter__(self):
        return iter(self._modules.values())


class HybridSequential(Sequential):
    """``Sequential`` (the port runs eagerly), named as the reference's
    (``hybridsequential0_``)."""


class Dense(Block):
    """Fully-connected layer: ``act(x @ weight.T + bias)``. With
    ``flatten`` the input is first reshaped to (batch, -1). Without
    ``in_units`` the weight takes its width at the first forward."""

    def __init__(self, units, activation=None, use_bias=True, flatten=True,
                 dtype="float32", weight_initializer=None,
                 bias_initializer="zeros", in_units=0, prefix=None,
                 params=None, device=None):
        super().__init__(prefix, params)
        dev, dt = resolve_device(device), _dtype(dtype)
        self._units = int(units)
        self._flatten = flatten
        self.weight = self._param((units, in_units), dt, dev,
                                  init=weight_initializer)
        self.bias = self._param((units,), dt, dev, init=bias_initializer) \
            if use_bias else None
        self.act = (Activation(activation, prefix=activation + "_")
                    if activation is not None else None)

    def forward(self, x):
        if self._deferred:
            in_units = math.prod(x.shape[1:]) if self._flatten \
                else x.shape[-1]
            self._finish_deferred(weight=(self._units, in_units))
        if self._flatten:
            x = x.reshape(x.shape[0], -1)
        out = F.linear(x, self.weight, self.bias)
        return self.act(out) if self.act is not None else out


class Embedding(Block):
    """Lookup table (input_dim, output_dim); out-of-range ids clip."""

    def __init__(self, input_dim, output_dim, dtype="float32",
                 weight_initializer=None, sparse_grad=False, prefix=None,
                 params=None, device=None):
        super().__init__(prefix, params)
        if sparse_grad:
            raise ValueError("sparse_grad=True: the port's gradients are "
                             "dense (row_sparse waits for ROADMAP 'Long "
                             "tail')")
        self.weight = self._param((input_dim, output_dim), _dtype(dtype),
                                  resolve_device(device),
                                  init=weight_initializer)

    def forward(self, x):
        return _nn.embedding(x, self.weight)


class LayerNorm(Block):
    """LayerNorm over ``axis``; the last axis runs the fused kernel.
    ``scale=False`` keeps gamma at its initial ones (no gradient),
    ``center=False`` beta at its zeros."""

    def __init__(self, axis=-1, epsilon=1e-5, center=True, scale=True,
                 beta_initializer="zeros", gamma_initializer="ones",
                 in_channels=0, dtype="float32", prefix=None, params=None,
                 device=None):
        super().__init__(prefix, params)
        dev, dt = resolve_device(device), _dtype(dtype)
        self._axis = axis
        self._epsilon = epsilon
        self.gamma = self._param((in_channels,), dt, dev, fill=1.0,
                                 grad_req="write" if scale else "null",
                                 init=gamma_initializer)
        self.beta = self._param((in_channels,), dt, dev,
                                grad_req="write" if center else "null",
                                init=beta_initializer)

    def forward(self, x):
        if self._deferred:
            c = (x.shape[self._axis],)
            self._finish_deferred(gamma=c, beta=c)
        return _nn.layer_norm(x, self.gamma, self.beta, axis=self._axis,
                              eps=self._epsilon)


class BatchNorm(Block):
    """BatchNorm over ``axis`` (channels) with running statistics, the
    JAX layer's semantics:

    - in train mode the batch statistics normalise (float32, the
      *biased* variance, the one-pass sums shifted by the running mean)
      and the running statistics take ``running * momentum + batch *
      (1 - momentum)`` at once, inside ``record()`` or not;
    - in predict mode (or with ``use_global_stats``) the running
      statistics normalise;
    - ``scale=False`` fixes gamma at one (no gradient), ``center=False``
      leaves beta at its zeros (no gradient);
    - the running statistics are parameters with ``grad_req="null"``:
      ``collect_params`` and ``load_gluon_params`` carry them, and the
      ``Trainer`` skips them;
    - :meth:`cast` to float16 or bfloat16 keeps every parameter
      float32: such data normalises in float32 and comes back in its
      own type."""

    def __init__(self, axis=1, momentum=0.9, epsilon=1e-5, center=True,
                 scale=True, use_global_stats=False,
                 beta_initializer="zeros", gamma_initializer="ones",
                 running_mean_initializer="zeros",
                 running_variance_initializer="ones", in_channels=0,
                 prefix=None, params=None, device=None):
        super().__init__(prefix, params)
        dev, dt = resolve_device(device), torch.float32
        self._axis = axis
        self._momentum = float(momentum)
        self._epsilon = float(epsilon)
        self._fix_gamma = not scale
        self._use_global_stats = use_global_stats
        shape = (in_channels,)
        self.gamma = self._param(shape, dt, dev, fill=1.0,
                                 init=gamma_initializer,
                                 grad_req="write" if scale else "null")
        self.beta = self._param(shape, dt, dev, init=beta_initializer,
                                grad_req="write" if center else "null")
        self.running_mean = self._param(shape, dt, dev,
                                        init=running_mean_initializer,
                                        grad_req="null")
        self.running_var = self._param(shape, dt, dev, fill=1.0,
                                       init=running_variance_initializer,
                                       grad_req="null")

    def cast(self, dtype):
        dt = _dtype(dtype)
        if dt in (torch.float16, torch.bfloat16):
            dt = torch.float32          # statistics in f32, as cuDNN
        return super().cast(dt)

    def forward(self, x):
        if self._deferred:
            c = (x.shape[self._axis],)
            self._finish_deferred(gamma=c, beta=c, running_mean=c,
                                  running_var=c)
        if autograd.is_training() and not self._use_global_stats:
            out, mean, var = _nn.batch_norm_train(
                x, self.gamma, self.beta, self.running_mean,
                eps=self._epsilon, axis=self._axis,
                fix_gamma=self._fix_gamma)
            m = self._momentum
            with torch.no_grad():
                rm, rv = self.running_mean, self.running_var
                rm.copy_(rm * m + mean.detach().to(rm.dtype) * (1 - m))
                rv.copy_(rv * m + var.detach().to(rv.dtype) * (1 - m))
            return out
        return _nn.batch_norm(x, self.gamma, self.beta, self.running_mean,
                              self.running_var, eps=self._epsilon,
                              fix_gamma=self._fix_gamma, axis=self._axis)


class Dropout(Block):
    """Dropout in train mode (``autograd.is_training()``, as the JAX
    layer reads it); the identity otherwise. ``axes``: the mask is drawn
    with those axes of size one and broadcast along them (one draw kept
    or dropped for a whole row of them), as the reference's."""

    def __init__(self, rate, axes=(), prefix=None, params=None):
        super().__init__(prefix, params)
        self._rate = float(rate)
        self._axes = tuple(int(a) for a in (
            (axes,) if isinstance(axes, int) else axes or ()))

    def forward(self, x):
        if not (autograd.is_training() and self._rate > 0):
            return x
        if not self._axes:
            return F.dropout(x, self._rate, training=True)
        shape = list(x.shape)
        for a in self._axes:
            shape[a] = 1
        keep = 1.0 - self._rate
        mask = torch.empty(shape, dtype=x.dtype, device=x.device) \
            .bernoulli_(keep)
        return x * mask / keep


class Activation(Block):
    """``Activation`` op by name (``ndarray.op_impl_nn.activation``)."""

    def __init__(self, activation, prefix=None, params=None):
        super().__init__(prefix, params)
        if activation not in _nn._ACT:
            raise ValueError(f"unknown activation {activation!r}")
        self._act_type = activation

    def forward(self, x):
        return _nn.activation(x, self._act_type)


class Flatten(Block):
    """(N, ...) -> (N, -1)."""

    def forward(self, x):
        return x.reshape(x.shape[0], -1)


class Identity(Block):
    """The input itself."""

    def forward(self, x):
        return x


class Lambda(Block):
    """A function as a block: a callable, or the name of an op of
    ``ndarray`` (``ndarray.op_impl_nn``'s included)."""

    def __init__(self, function, prefix=None, params=None):
        super().__init__(prefix, params)
        if isinstance(function, str):
            fn = getattr(ndarray, function, None) \
                or getattr(ndarray.op_impl_nn, function, None)
            if fn is None:
                raise ValueError(f"no op named {function!r}")
            function = fn
        self._func = function

    def forward(self, *args):
        return self._func(*args)


class HybridLambda(Lambda):
    """``Lambda`` whose callable takes the op namespace first, as a
    ``hybrid_forward`` does: ``fn(F, x, *args)`` with ``F`` the port's
    ``ndarray``. A name is an op called as ``op(x, *args)``."""

    def __init__(self, function, prefix=None, params=None):
        if isinstance(function, str):
            super().__init__(function, prefix, params)
        else:
            super().__init__(
                lambda *args: function(ndarray, *args), prefix, params)
