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
and the dispatch do not. All of the JAX module is here: ``Zero``,
``One``, ``Constant``, ``Uniform``, ``Normal``, ``Orthogonal``,
``Xavier``, ``MSRAPrelu``, ``Bilinear``, ``LSTMBias``, ``Mixed``,
``create`` and ``register``. ``Bilinear`` computes a row ``y = (i /
shape[3]) % shape[2]`` with true division, as the JAX package does
(MXNet divides integers); the port keeps the JAX package's values.
For the symbolic API (``Module.init_params``): an :class:`InitDesc`
name may carry a variable's attributes, whose ``__init__`` (an
initializer's :meth:`Initializer.dumps`, as ``mx.sym.Variable(init=...)``
writes it) overrides the initializer called, and :func:`create` reads
that JSON form back.
"""
from __future__ import annotations

import json
import math
import re

import numpy as np
import torch

__all__ = ["Bilinear", "Constant", "InitDesc", "Initializer", "LSTMBias",
           "MSRAPrelu", "Mixed", "Normal", "One", "Orthogonal", "Uniform",
           "Xavier", "Zero", "create", "register"]

_REGISTRY = {}


def register(name):
    """Class decorator: register an initializer under ``name``."""
    def deco(klass):
        _REGISTRY[name] = klass
        return klass
    return deco


class InitDesc(str):
    """A parameter's name with its variable's attributes (``attrs``)."""

    def __new__(cls, name, attrs=None, global_init=None):
        obj = super().__new__(cls, name)
        obj.attrs = attrs or {}
        obj.global_init = global_init
        return obj


class Initializer:
    """Base: ``init(name, tensor, rng)`` fills ``tensor`` in place."""

    def __init__(self, **kwargs):
        self._kwargs = kwargs

    def __call__(self, name, arr, rng=None):
        rng = np.random.default_rng(0) if rng is None else rng
        init = getattr(name, "attrs", {}).get("__init__", "")
        if init:
            create(init)._init_weight(name, arr, rng)
            return
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

    def dumps(self):
        """``[name, kwargs]`` as JSON, which :func:`create` reads."""
        return json.dumps([type(self).__name__.lower(), self._kwargs])

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


@register("orthogonal")
class Orthogonal(Initializer):
    """An orthogonal matrix (of the SVD of a uniform or normal draw,
    the rows' shape ``(shape[0], prod(shape[1:]))``) times ``scale``."""

    def __init__(self, scale=1.414, rand_type="uniform"):
        super().__init__(scale=scale, rand_type=rand_type)
        self.scale = scale
        self.rand_type = rand_type

    def _init_weight(self, _, arr, rng):
        nout = arr.shape[0]
        nin = int(np.prod(arr.shape[1:]))
        if self.rand_type == "uniform":
            tmp = rng.uniform(-1.0, 1.0, (nout, nin))
        else:
            tmp = rng.normal(0.0, 1.0, (nout, nin))
        u, _, v = np.linalg.svd(tmp, full_matrices=False)
        q = u if u.shape == tmp.shape else v
        self._set(arr, self.scale * q.reshape(arr.shape))


@register("msraprelu")
class MSRAPrelu(Xavier):
    """He initialization for PReLU: a normal Xavier of magnitude ``2 /
    (1 + slope ** 2)``."""

    def __init__(self, factor_type="avg", slope=0.25):
        magnitude = 2.0 / (1 + slope ** 2)
        super().__init__("gaussian", factor_type, magnitude)
        self._kwargs = {"factor_type": factor_type, "slope": slope}


@register("bilinear")
class Bilinear(Initializer):
    """An upsampling filter: ``(1 - |x / f - c|) * (1 - |y / f - c|)``
    over the last two axes (``y`` as the module docstring says)."""

    def _init_weight(self, _, arr, rng):
        shape = arr.shape
        weight = np.zeros(int(np.prod(shape)), dtype=np.float32)
        f = np.ceil(shape[3] / 2.0)
        c = (2 * f - 1 - f % 2) / (2.0 * f)
        for i in range(int(np.prod(shape))):
            x = i % shape[3]
            y = (i / shape[3]) % shape[2]
            weight[i] = (1 - abs(x / f - c)) * (1 - abs(y / f - c))
        self._set(arr, weight.reshape(shape))


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


class Mixed:
    """The first of ``initializers`` whose pattern (a regular
    expression, matched at the name's start) matches the parameter's
    name initializes it."""

    def __init__(self, patterns, initializers):
        self.map = list(zip([re.compile(p) for p in patterns],
                            initializers))

    def __call__(self, name, arr, rng=None):
        for prog, init in self.map:
            if prog.match(name):
                init(name, arr, rng)
                return
        raise ValueError(f"parameter {name} did not match any pattern")


def create(name, **kwargs):
    """An initializer by registered name (or its :meth:`Initializer.dumps`
    JSON); an ``Initializer`` (or any other callable) passes through."""
    if isinstance(name, Initializer) or (not isinstance(name, str)
                                         and callable(name)):
        return name
    if name.startswith("["):
        name, kwargs = json.loads(name)
    try:
        klass = _REGISTRY[name.lower()]
    except KeyError:
        raise ValueError(f"unknown initializer {name!r}; registered: "
                         f"{sorted(_REGISTRY)}") from None
    return klass(**kwargs)
