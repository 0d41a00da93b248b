"""Basic layers: Sequential, HybridSequential, Dense, Embedding,
BatchNorm, LayerNorm, Dropout, Activation, Flatten, Identity, Lambda,
HybridLambda, and InstanceNorm, GroupNorm, LeakyReLU, PReLU, ELU,
SELU, GELU, Swish and SiLU.

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

Each layer also carries the JAX layer's ``hybrid_forward`` in F-ops,
which a Symbol goes through (``export``, ``gluon.block``'s
``_call_symbolic``): tensors keep the torch ``forward``. The layers
added with their symbolic forms (InstanceNorm, GroupNorm and the
activations from LeakyReLU on) have no torch ``forward`` of their
own: on tensors they run that ``hybrid_forward`` over ``mx.nd``, as a
user's block does, their parameters made with ``self.params.get``.
``BatchNorm``'s symbolic form is its predict-mode op, the graph
``export`` writes.

Under ``contrib.amp`` each torch ``forward`` casts its tensors by the
name of the op its ``hybrid_forward`` emits (``register.amp_cast``):
Dense and Embedding run in the half type, LayerNorm and predict-mode
BatchNorm in float32, and train-mode BatchNorm (``BatchNormTrain``,
which no list names) on its inputs' own types, as in the JAX package.
"""
from __future__ import annotations

import math
import warnings

import torch
import torch.nn.functional as F

from ... import autograd, ndarray
from ...context import resolve_device
from ...ndarray import op_impl_nn as _nn
from ...ndarray.register import amp_cast
from ..block import Block, HybridBlock, aux_updates_on

__all__ = ["Activation", "BatchNorm", "Dense", "Dropout", "ELU", "Embedding",
           "Flatten", "GELU", "GroupNorm", "HybridLambda",
           "HybridSequential", "Identity", "InstanceNorm", "Lambda",
           "LayerNorm", "LeakyReLU", "PReLU", "SELU", "SiLU", "Sequential",
           "Swish"]


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

    def hybridize(self, active=True, **kwargs):
        """Hybridize the children, each its own graph (a ``Sequential``
        stays eager itself); warns when all of them could run as one
        ``HybridSequential`` graph, as the reference does."""
        children = list(self.children())
        if children and all(isinstance(c, HybridBlock) for c in children):
            warnings.warn(
                f"All children of this Sequential layer '{self.prefix}' are "
                "HybridBlocks, so it is recommended to use HybridSequential "
                "for the best performance.", stacklevel=2)
        return super().hybridize(active, **kwargs)


class HybridSequential(HybridBlock, Sequential):
    """``Sequential`` that hybridizes into one graph, named as the
    reference's (``hybridsequential0_``)."""

    def hybrid_forward(self, F, x, *args):
        for block in self._modules.values():
            x = block(x)
        return x


class Dense(HybridBlock):
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
        x, weight, bias = amp_cast("FullyConnected", x, self.weight,
                                   self.bias)
        out = F.linear(x, weight, bias)
        return self.act(out) if self.act is not None else out

    def hybrid_forward(self, F, x, weight, bias=None):
        out = F.FullyConnected(x, weight, bias, no_bias=bias is None,
                               num_hidden=self._units, flatten=self._flatten)
        if self.act is not None:
            out = self.act(out)
        return out


class Embedding(HybridBlock):
    """Lookup table (input_dim, output_dim); out-of-range ids clip.
    ``sparse_grad=True`` gives the weight ``grad_stype="row_sparse"``,
    as the JAX layer does, and its gradient stays dense (the JAX
    ``take``'s), so an optimizer updates every row, as there."""

    def __init__(self, input_dim, output_dim, dtype="float32",
                 weight_initializer=None, sparse_grad=False, prefix=None,
                 params=None, device=None):
        super().__init__(prefix, params)
        self._input_dim, self._output_dim = input_dim, output_dim
        self._sparse_grad = bool(sparse_grad)
        self.weight = self._param((input_dim, output_dim), _dtype(dtype),
                                  resolve_device(device),
                                  init=weight_initializer)
        if sparse_grad:
            self.weight._mx_grad_stype = "row_sparse"

    def forward(self, x):
        return _nn.embedding(*amp_cast("Embedding", x, self.weight))

    def hybrid_forward(self, F, x, weight):
        return F.Embedding(x, weight, input_dim=self._input_dim,
                           output_dim=self._output_dim,
                           sparse_grad=self._sparse_grad)


class LayerNorm(HybridBlock):
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
        x, gamma, beta = amp_cast("LayerNorm", x, self.gamma, self.beta)
        return _nn.layer_norm(x, gamma, beta, axis=self._axis,
                              eps=self._epsilon)

    def hybrid_forward(self, F, x, gamma, beta):
        return F.LayerNorm(x, gamma, beta, axis=self._axis, eps=self._epsilon)


class BatchNorm(HybridBlock):
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
            x, gamma, beta, shift = amp_cast(
                "BatchNormTrain", x, self.gamma, self.beta,
                self.running_mean)
            out, mean, var = _nn.batch_norm_train(
                x, gamma, beta, shift, eps=self._epsilon, axis=self._axis,
                fix_gamma=self._fix_gamma)
            m = self._momentum
            if aux_updates_on():
                with torch.no_grad():
                    rm, rv = self.running_mean, self.running_var
                    rm.copy_(rm * m + mean.detach().to(rm.dtype) * (1 - m))
                    rv.copy_(rv * m + var.detach().to(rv.dtype) * (1 - m))
            return out
        x, gamma, beta, mean, var = amp_cast(
            "BatchNorm", x, self.gamma, self.beta, self.running_mean,
            self.running_var)
        return _nn.batch_norm(x, gamma, beta, mean, var, eps=self._epsilon,
                              fix_gamma=self._fix_gamma, axis=self._axis)

    def hybrid_forward(self, F, x, gamma, beta, running_mean, running_var):
        return F.BatchNorm(x, gamma, beta, running_mean, running_var,
                           axis=self._axis, eps=self._epsilon,
                           momentum=self._momentum, fix_gamma=self._fix_gamma,
                           use_global_stats=self._use_global_stats)


class Dropout(HybridBlock):
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

    def hybrid_forward(self, F, x):
        if self._rate > 0:
            return F.Dropout(x, p=self._rate, axes=self._axes)
        return F.copy(x)


class Activation(HybridBlock):
    """``Activation`` op by name (``ndarray.op_impl_nn.activation``),
    named after it (``relu0_``), as the reference's."""

    def __init__(self, activation, prefix=None, params=None):
        if activation not in _nn._ACT:
            raise ValueError(f"unknown activation {activation!r}")
        self._act_type = activation
        super().__init__(prefix, params)

    def _alias(self):
        return self._act_type

    def forward(self, x):
        return _nn.activation(x, self._act_type)

    def hybrid_forward(self, F, x):
        return F.Activation(x, act_type=self._act_type)


class Flatten(HybridBlock):
    """(N, ...) -> (N, -1)."""

    def forward(self, x):
        return x.reshape(x.shape[0], -1)

    def hybrid_forward(self, F, x):
        return F.Flatten(x)


class Identity(HybridBlock):
    """The input itself."""

    def forward(self, x):
        return x

    def hybrid_forward(self, F, x):
        return F.copy(x)


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


class HybridLambda(HybridBlock, Lambda):
    """``Lambda`` whose callable takes the op namespace first, as a
    ``hybrid_forward`` does: ``fn(F, x, *args)`` with ``F`` the port's
    ``ndarray``. A name is an op called as ``op(x, *args)``."""

    def __init__(self, function, prefix=None, params=None):
        if isinstance(function, str):
            super().__init__(function, prefix, params)
        else:
            super().__init__(
                lambda *args: function(ndarray, *args), prefix, params)
        self._function = function

    def hybrid_forward(self, F, x, *args):
        if isinstance(self._function, str):
            return getattr(F, self._function)(x, *args)
        return self._function(F, x, *args)


# -- the layers that run their hybrid_forward on tensors too --------------
class _Norm(HybridBlock):
    """gamma and beta of ``in_channels`` (0: from the first input's
    channel axis), made with ``self.params.get`` as the JAX layers'."""

    def __init__(self, axis, center, scale, beta_initializer,
                 gamma_initializer, in_channels, prefix, params, device):
        super().__init__(prefix, params)
        self._axis = axis
        self.in_channels = in_channels
        with self.name_scope():
            self.gamma = self.params.get(
                "gamma", grad_req="write" if scale else "null",
                shape=(in_channels,), init=gamma_initializer, ctx=device)
            self.beta = self.params.get(
                "beta", grad_req="write" if center else "null",
                shape=(in_channels,), init=beta_initializer, ctx=device)

    def infer_shape(self, x, *args):
        channels = x.shape[self._axis]
        self.gamma.shape = (channels,)
        self.beta.shape = (channels,)


class InstanceNorm(_Norm):
    """Normalises each (example, channel) over the spatial axes (the
    ``InstanceNorm`` op); ``scale=False`` by default, as the JAX
    layer's."""

    def __init__(self, axis=1, epsilon=1e-5, center=True, scale=False,
                 beta_initializer="zeros", gamma_initializer="ones",
                 in_channels=0, prefix=None, params=None, device=None):
        super().__init__(axis, center, scale, beta_initializer,
                         gamma_initializer, in_channels, prefix, params,
                         device)
        self._epsilon = epsilon

    def hybrid_forward(self, F, x, gamma, beta):
        return F.InstanceNorm(x, gamma, beta, eps=self._epsilon)


class GroupNorm(_Norm):
    """Normalises ``num_groups`` groups of channels of each example (the
    ``GroupNorm`` op)."""

    def __init__(self, num_groups=1, epsilon=1e-5, center=True, scale=True,
                 beta_initializer="zeros", gamma_initializer="ones",
                 in_channels=0, prefix=None, params=None, device=None):
        super().__init__(1, center, scale, beta_initializer,
                         gamma_initializer, in_channels, prefix, params,
                         device)
        self._num_groups = num_groups
        self._epsilon = epsilon

    def hybrid_forward(self, F, x, gamma, beta):
        return F.GroupNorm(x, gamma, beta, num_groups=self._num_groups,
                           eps=self._epsilon)


class LeakyReLU(HybridBlock):
    """``x`` where positive, ``alpha * x`` elsewhere."""

    def __init__(self, alpha, prefix=None, params=None):
        super().__init__(prefix, params)
        self._alpha = alpha

    def hybrid_forward(self, F, x):
        return F.LeakyReLU(x, act_type="leaky", slope=self._alpha)


class PReLU(HybridBlock):
    """LeakyReLU with a learnt slope a channel (``alpha``, zeros at
    first as the JAX layer's)."""

    def __init__(self, alpha_initializer="zeros", in_channels=1, prefix=None,
                 params=None, device=None):
        super().__init__(prefix, params)
        with self.name_scope():
            self.alpha = self.params.get("alpha", shape=(in_channels,),
                                         init=alpha_initializer, ctx=device)

    def hybrid_forward(self, F, x, alpha):
        return F.LeakyReLU(x, gamma=alpha, act_type="prelu")


class ELU(HybridBlock):
    """``x`` where positive, ``alpha * (exp(x) - 1)`` elsewhere."""

    def __init__(self, alpha=1.0, prefix=None, params=None):
        super().__init__(prefix, params)
        self._alpha = alpha

    def hybrid_forward(self, F, x):
        return F.LeakyReLU(x, act_type="elu", slope=self._alpha)


class SELU(HybridBlock):
    """Scaled ELU (Klambauer et al. 2017)."""

    def hybrid_forward(self, F, x):
        return F.LeakyReLU(x, act_type="selu")


class GELU(HybridBlock):
    """GELU, the erf form or (``approximation="tanh"``) the tanh one."""

    def __init__(self, approximation="erf", prefix=None, params=None):
        super().__init__(prefix, params)
        self._approx = approximation != "erf"

    def hybrid_forward(self, F, x):
        return F.gelu(x, approximate=self._approx)


class Swish(HybridBlock):
    """``x * sigmoid(beta * x)``."""

    def __init__(self, beta=1.0, prefix=None, params=None):
        super().__init__(prefix, params)
        self._beta = beta

    def hybrid_forward(self, F, x):
        return F.swish(x, beta=self._beta)


class SiLU(Swish):
    """Swish with ``beta`` 1."""
