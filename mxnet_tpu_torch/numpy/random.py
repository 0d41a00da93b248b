"""``mx.np.random``: NumPy-style sampling.

Port of ``mxnet_tpu/numpy/random.py``. Draws with scalar parameters
dispatch the classic ``random_*`` ops; the distributions the classic
family lacks dispatch ``_npi_random_*`` (``numpy/ops.py``). Every draw
comes from the device's generator (``mx.random``): the bits differ
from ``jax.random``'s by design, the distributions do not.
``size=None`` gives a 0-d array, as NumPy's."""
from __future__ import annotations

import numpy as onp
import torch

from .. import random as _base_random
from .multiarray import _np_invoke, _proc, arange, asarray

__all__ = ["seed", "uniform", "normal", "randn", "rand", "randint",
           "choice", "shuffle", "permutation", "gamma", "beta",
           "exponential", "chisquare", "lognormal", "laplace", "logistic",
           "gumbel", "pareto", "power", "rayleigh", "weibull",
           "multinomial", "poisson"]


def seed(seed_state):
    _base_random.seed(seed_state)


def uniform(low=0.0, high=1.0, size=None, dtype="float32"):
    return _np_invoke("random_uniform", [],
                      {"low": low, "high": high, "shape": size,
                       "dtype": dtype})


def normal(loc=0.0, scale=1.0, size=None, dtype="float32"):
    return _np_invoke("random_normal", [],
                      {"loc": loc, "scale": scale, "shape": size,
                       "dtype": dtype})


def randn(*size):
    return normal(0.0, 1.0, size or None)


def rand(*size):
    return uniform(0.0, 1.0, size or None)


def randint(low, high=None, size=None, dtype="int32"):
    if high is None:
        low, high = 0, low
    return _np_invoke("random_randint", [],
                      {"low": low, "high": high, "shape": size,
                       "dtype": dtype})


def choice(a, size=None, replace=True, p=None):
    a = arange(a) if isinstance(a, int) else _proc(a)
    inputs = [a] if p is None else [a, _proc(p, a)]
    return _np_invoke("_npi_random_choice", inputs,
                      {"size": size, "replace": replace})


def shuffle(x):
    """Permute ``x`` along its first axis, in place (NumPy's)."""
    out = _np_invoke("shuffle", [_proc(x)])
    with torch.no_grad():
        torch.Tensor.copy_(x, out)


def permutation(x):
    if isinstance(x, int):
        x = arange(x)
    return _np_invoke("_npi_random_permutation", [_proc(x)])


def gamma(shape, scale=1.0, size=None, dtype="float32"):
    return _np_invoke("random_gamma", [],
                      {"alpha": shape, "beta": scale, "shape": size,
                       "dtype": dtype})


def beta(a, b, size=None):
    return _np_invoke("_npi_random_beta", [], {"a": a, "b": b, "size": size})


def exponential(scale=1.0, size=None):
    return _np_invoke("random_exponential", [],
                      {"lam": 1.0 / scale, "shape": size})


def chisquare(df, size=None):
    return _np_invoke("_npi_random_chisquare", [], {"df": df, "size": size})


def lognormal(mean=0.0, sigma=1.0, size=None):
    return _np_invoke("_npi_random_lognormal", [],
                      {"mean": mean, "sigma": sigma, "size": size})


def laplace(loc=0.0, scale=1.0, size=None):
    return _np_invoke("_npi_random_laplace", [],
                      {"loc": loc, "scale": scale, "size": size})


def logistic(loc=0.0, scale=1.0, size=None):
    return _np_invoke("_npi_random_logistic", [],
                      {"loc": loc, "scale": scale, "size": size})


def gumbel(loc=0.0, scale=1.0, size=None):
    return _np_invoke("_npi_random_gumbel", [],
                      {"loc": loc, "scale": scale, "size": size})


def pareto(a, size=None):
    return _np_invoke("_npi_random_pareto", [], {"a": a, "size": size})


def power(a, size=None):
    return _np_invoke("_npi_random_power", [], {"a": a, "size": size})


def rayleigh(scale=1.0, size=None):
    return _np_invoke("_npi_random_rayleigh", [],
                      {"scale": scale, "size": size})


def weibull(a, size=None):
    return _np_invoke("_npi_random_weibull", [], {"a": a, "size": size})


def multinomial(n, pvals, size=None):
    """Counts over ``len(pvals)`` outcomes: ``sample_multinomial`` then
    ``one_hot``, one dispatch each for any ``size``."""
    k = len(pvals)
    if size is None:
        reps, out_shape = 1, (k,)
    elif isinstance(size, int):
        reps, out_shape = size, (size, k)
    else:
        reps = int(onp.prod(size))
        out_shape = tuple(size) + (k,)
    probs = asarray([list(map(float, pvals))])
    draws = _np_invoke("sample_multinomial", [probs],
                       {"shape": (reps * int(n),)})
    oh = _np_invoke("one_hot", [draws.reshape(reps, int(n))], {"depth": k})
    return oh.sum(axis=1).astype("int64").reshape(out_shape)


def poisson(lam=1.0, size=None):
    return _np_invoke("random_poisson", [], {"lam": lam, "shape": size})
