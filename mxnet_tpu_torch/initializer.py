"""Weight initializers (``mxnet_tpu/initializer.py``'s counterpart).

The same registry and the same name dispatch as the JAX package (and
MXNet's ``Initializer.__call__``): an initializer is called with a
parameter's name and its tensor, and a name ending in ``weight`` takes
the initializer's own draw, ``bias``/``beta`` zeros, ``gamma`` ones,
running means zeros and running variances ones.

Draws come from an explicit ``numpy.random.Generator`` handed in by the
caller (``Block.initialize`` makes one from its ``seed`` and passes it
to every parameter in registration order), so one seed gives the same
weights on every device. The JAX package derives its generator from
``jax.random`` keys, so the bits differ from it by design; the scales
and the dispatch do not. Ported: ``Zero``, ``One``, ``Constant``,
``Uniform``, ``Normal``, ``Xavier``, ``LSTMBias``, ``create`` and
``register``.
"""
from __future__ import annotations

import math

import numpy as np
import torch

__all__ = ["Constant", "Initializer", "LSTMBias", "Normal", "One", "Uniform",
           "Xavier", "Zero", "create", "register"]

_REGISTRY = {}


def register(name):
    """Class decorator: register an initializer under ``name``."""
    def deco(klass):
        _REGISTRY[name] = klass
        return klass
    return deco


class Initializer:
    """Base: ``init(name, tensor, rng)`` fills ``tensor`` in place."""

    def __init__(self, **kwargs):
        self._kwargs = kwargs

    def __call__(self, name, arr, rng=None):
        rng = np.random.default_rng(0) if rng is None else rng
        name = str(name).lower()
        if name.endswith("weight"):
            self._init_weight(name, arr, rng)
        elif name.endswith("bias"):
            self._init_bias(name, arr, rng)
        elif name.endswith("gamma"):
            self._init_gamma(name, arr, rng)
        elif name.endswith("beta"):
            self._init_beta(name, arr, rng)
        elif name.endswith(("running_mean", "moving_mean")):
            self._init_zero(name, arr, rng)
        elif name.endswith(("running_var", "moving_var")):
            self._init_one(name, arr, rng)
        else:
            self._init_weight(name, arr, rng)

    @staticmethod
    @torch.no_grad()
    def _set(arr, value):
        arr.copy_(torch.as_tensor(np.asarray(value), dtype=arr.dtype))

    def _init_zero(self, _, arr, rng):
        self._set(arr, np.zeros(arr.shape))

    def _init_one(self, _, arr, rng):
        self._set(arr, np.ones(arr.shape))

    def _init_bias(self, name, arr, rng):
        self._init_zero(name, arr, rng)

    def _init_gamma(self, name, arr, rng):
        self._init_one(name, arr, rng)

    def _init_beta(self, name, arr, rng):
        self._init_zero(name, arr, rng)

    def _init_weight(self, name, arr, rng):
        raise NotImplementedError

    def __repr__(self):
        return f"{type(self).__name__}({self._kwargs})"


@register("zeros")
class Zero(Initializer):
    def _init_weight(self, name, arr, rng):
        self._init_zero(name, arr, rng)


@register("ones")
class One(Initializer):
    def _init_weight(self, name, arr, rng):
        self._init_one(name, arr, rng)


@register("constant")
class Constant(Initializer):
    def __init__(self, value=0.0):
        super().__init__(value=value)
        self.value = value

    def _init_weight(self, _, arr, rng):
        self._set(arr, np.full(arr.shape, self.value))


@register("uniform")
class Uniform(Initializer):
    """Weights ~ U(-scale, scale)."""

    def __init__(self, scale=0.07):
        super().__init__(scale=scale)
        self.scale = scale

    def _init_weight(self, _, arr, rng):
        self._set(arr, rng.uniform(-self.scale, self.scale, arr.shape))


@register("normal")
class Normal(Initializer):
    """Weights ~ N(0, sigma^2)."""

    def __init__(self, sigma=0.01):
        super().__init__(sigma=sigma)
        self.sigma = sigma

    def _init_weight(self, _, arr, rng):
        self._set(arr, rng.normal(0.0, self.sigma, arr.shape))


@register("xavier")
class Xavier(Initializer):
    """Glorot: scale = sqrt(magnitude / factor), factor the average of
    fan-in and fan-out (``"avg"``), fan-in (``"in"``) or fan-out
    (``"out"``); uniform in [-scale, scale] or normal with that
    deviation (``rnd_type="gaussian"``)."""

    def __init__(self, rnd_type="uniform", factor_type="avg", magnitude=3):
        super().__init__(rnd_type=rnd_type, factor_type=factor_type,
                         magnitude=magnitude)
        self.rnd_type = rnd_type
        self.factor_type = factor_type
        self.magnitude = float(magnitude)

    def scale(self, shape):
        """The draw's scale for a weight of ``shape``."""
        if len(shape) < 2:
            raise ValueError(f"Xavier requires ndim>=2, got shape {shape}")
        hw_scale = float(np.prod(shape[2:])) if len(shape) > 2 else 1.0
        fan_in, fan_out = shape[1] * hw_scale, shape[0] * hw_scale
        factor = {"avg": (fan_in + fan_out) / 2.0, "in": fan_in,
                  "out": fan_out}[self.factor_type]
        return math.sqrt(self.magnitude / factor)

    def _init_weight(self, name, arr, rng):
        shape = tuple(arr.shape)
        scale = self.scale(shape)
        if self.rnd_type == "uniform":
            self._set(arr, rng.uniform(-scale, scale, shape))
        else:
            self._set(arr, rng.normal(0.0, scale, shape))


@register("lstmbias")
class LSTMBias(Initializer):
    """Zeros with the forget gate's quarter (gate order i, f, g, o) at
    ``forget_bias``."""

    def __init__(self, forget_bias=1.0):
        super().__init__(forget_bias=forget_bias)
        self.forget_bias = forget_bias

    def _init_weight(self, _, arr, rng):
        b = np.zeros(arr.shape, dtype=np.float32)
        hid = int(b.shape[0] / 4)
        b[hid:2 * hid] = self.forget_bias
        self._set(arr, b)

    _init_bias = _init_weight


def create(name, **kwargs):
    """An initializer by registered name; an ``Initializer`` (or any
    other callable) passes through."""
    if isinstance(name, Initializer) or (not isinstance(name, str)
                                         and callable(name)):
        return name
    try:
        klass = _REGISTRY[name.lower()]
    except KeyError:
        raise ValueError(f"unknown initializer {name!r}; registered: "
                         f"{sorted(_REGISTRY)}") from None
    return klass(**kwargs)
