"""Random sampling operators.

Port of ``mxnet_tpu/ndarray/op_impl_random.py`` (MXNet's
``src/operator/random/sample_op``): the ``random_*`` samplers of a
given shape, the ``sample_*`` ops with per-element distribution
parameters, ``sample_multinomial``, ``shuffle`` and ``bernoulli``, with
the JAX ops' names, aliases and parameters. Every draw comes from the
device's generator (``mx.random``: ``mx.random.seed`` makes a run
repeat); the bits differ from ``jax.random``'s by design, the
distributions do not. Non-differentiable, as MXNet's.
"""
from __future__ import annotations

import numpy as np
import torch

from .. import random as _random
from .ndarray import to_dtype
from .register import register_op

__all__ = ["bernoulli", "random_exponential", "random_gamma",
           "random_negative_binomial", "random_normal", "random_poisson",
           "random_randint", "random_uniform", "sample_gamma",
           "sample_multinomial", "sample_normal", "sample_uniform",
           "shuffle"]


def _shape(shape):
    if shape is None:
        return ()
    if isinstance(shape, int):
        return (shape,)
    return tuple(int(s) for s in shape)


def _gen(device):
    return _random.generator(torch.device(device or "cpu"))


def _empty(shape, dtype, device):
    return torch.empty(_shape(shape), dtype=to_dtype(dtype or "float32"),
                       device=device)


def _gamma(alpha, shape, device, dtype=torch.float32):
    """Gamma(alpha, 1) draws of ``shape`` (``alpha`` broadcast), from
    the device's generator: torch's ``_standard_gamma`` takes none, so
    Marsaglia-Tsang with the boost for alpha < 1."""
    gen = _gen(device)
    a = torch.as_tensor(alpha, dtype=torch.float64, device=device) \
        .expand(shape) if shape else torch.as_tensor(
            alpha, dtype=torch.float64, device=device)
    boost = a < 1
    a1 = torch.where(boost, a + 1, a)
    d = a1 - 1.0 / 3.0
    c = 1.0 / torch.sqrt(9.0 * d)
    out = torch.zeros_like(a1)
    todo = torch.ones_like(a1, dtype=torch.bool)
    while bool(todo.any()):
        z = torch.empty_like(a1).normal_(generator=gen)
        u = torch.empty_like(a1).uniform_(generator=gen)
        v = (1 + c * z) ** 3
        ok = (v > 0) & (torch.log(u.clamp_min(1e-300))
                        < 0.5 * z * z + d - d * v
                        + d * torch.log(v.clamp_min(1e-300)))
        take = todo & ok
        out = torch.where(take, d * v, out)
        todo = todo & ~ok
    u = torch.empty_like(a1).uniform_(generator=gen)
    out = torch.where(boost, out * u.clamp_min(1e-300) ** (1.0 / a), out)
    return out.to(dtype)


def _poisson(lam, device):
    return torch.poisson(lam.to(torch.float32), generator=_gen(device))


@register_op("random_uniform", aliases=("_random_uniform", "uniform"),
             differentiable=False)
def random_uniform(low=0.0, high=1.0, shape=None, dtype="float32", ctx=None,
                   device=None):
    return _empty(shape, dtype, device).uniform_(low, high,
                                                 generator=_gen(device))


@register_op("random_normal", aliases=("_random_normal", "normal"),
             differentiable=False)
def random_normal(loc=0.0, scale=1.0, shape=None, dtype="float32", ctx=None,
                  device=None):
    return _empty(shape, dtype, device).normal_(loc, scale,
                                                generator=_gen(device))


@register_op("random_gamma", aliases=("_random_gamma",),
             differentiable=False)
def random_gamma(alpha=1.0, beta=1.0, shape=None, dtype="float32", ctx=None,
                 device=None):
    return beta * _gamma(alpha, _shape(shape), device,
                         to_dtype(dtype or "float32"))


@register_op("random_exponential",
             aliases=("_random_exponential", "exponential"),
             differentiable=False)
def random_exponential(lam=1.0, shape=None, dtype="float32", ctx=None,
                       device=None):
    return _empty(shape, dtype, device).exponential_(lam,
                                                     generator=_gen(device))


@register_op("random_poisson", aliases=("_random_poisson", "poisson"),
             differentiable=False)
def random_poisson(lam=1.0, shape=None, dtype="float32", ctx=None,
                   device=None):
    rate = torch.full(_shape(shape), float(lam), device=device)
    return _poisson(rate, device).to(to_dtype(dtype or "float32"))


@register_op("random_negative_binomial",
             aliases=("_random_negative_binomial",), differentiable=False)
def random_negative_binomial(k=1, p=1.0, shape=None, dtype="float32",
                             ctx=None, device=None):
    lam = _gamma(float(k), _shape(shape), device) * ((1 - p) / p)
    return _poisson(lam, device).to(to_dtype(dtype or "float32"))


@register_op("random_randint", aliases=("_random_randint", "randint"),
             differentiable=False)
def random_randint(low=0, high=100, shape=None, dtype="int32", ctx=None,
                   device=None):
    return torch.randint(int(low), int(high), _shape(shape),
                         generator=_gen(device), device=device,
                         dtype=to_dtype(dtype or "int32"))


def _trail(t, s):
    return t.reshape(tuple(t.shape) + (1,) * len(s))


@register_op("sample_uniform", differentiable=False)
def sample_uniform(low, high, shape=None, dtype=None):
    s = _shape(shape)
    u = torch.empty(tuple(low.shape) + s, dtype=low.dtype,
                    device=low.device).uniform_(generator=_gen(low.device))
    return _trail(low, s) + u * (_trail(high, s) - _trail(low, s))


@register_op("sample_normal", differentiable=False)
def sample_normal(mu, sigma, shape=None, dtype=None):
    s = _shape(shape)
    z = torch.empty(tuple(mu.shape) + s, dtype=mu.dtype,
                    device=mu.device).normal_(generator=_gen(mu.device))
    return _trail(mu, s) + z * _trail(sigma, s)


@register_op("sample_gamma", differentiable=False)
def sample_gamma(alpha, beta, shape=None, dtype=None):
    s = _shape(shape)
    shp = tuple(alpha.shape) + s
    g = _gamma(_trail(alpha, s).expand(shp), shp, alpha.device, alpha.dtype)
    return g * _trail(beta, s)


@register_op("sample_multinomial",
             aliases=("_sample_multinomial", "multinomial"),
             differentiable=False)
def sample_multinomial(data, shape=None, get_prob=False, dtype="int32"):
    """Category draws from the last axis of ``data`` (probabilities);
    ``get_prob`` also gives each draw's log-probability."""
    s = _shape(shape)
    n = int(np.prod(s)) if s else 1
    probs = data.reshape(-1, data.shape[-1]).to(torch.float32)
    idx = torch.multinomial(probs, n, replacement=True,
                            generator=_gen(data.device))      # (rows, n)
    out = idx.reshape(tuple(data.shape[:-1]) + (s if s else ()))
    out = out.to(to_dtype(dtype or "int32"))
    if get_prob:
        logp = torch.log(torch.clamp(data, min=1e-37))
        picked = torch.gather(
            logp.reshape(-1, data.shape[-1]), 1,
            idx.reshape(probs.shape[0], -1)).reshape(out.shape)
        return out, picked
    return out


@register_op("shuffle", aliases=("_shuffle",), differentiable=False)
def shuffle(data):
    perm = torch.randperm(data.shape[0], generator=_gen(data.device),
                          device=data.device)
    return data[perm]


@register_op("bernoulli", aliases=("_sample_bernoulli",),
             differentiable=False)
def bernoulli(prob=None, logit=None, shape=None, dtype="float32",
              device=None):
    if prob is None and logit is not None:
        prob = torch.sigmoid(logit) if isinstance(logit, torch.Tensor) \
            else 1.0 / (1.0 + np.exp(-logit))
    if isinstance(prob, torch.Tensor):
        device = prob.device
        s = _shape(shape) or tuple(prob.shape)
        p = prob.expand(s).to(torch.float32)
    else:
        p = torch.full(_shape(shape), float(prob), device=device)
    return torch.bernoulli(p, generator=_gen(device)) \
        .to(to_dtype(dtype or "float32"))
