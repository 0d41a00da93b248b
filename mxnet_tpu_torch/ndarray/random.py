"""``mx.nd.random``: the sampling namespace (port of
``mxnet_tpu/ndarray/random.py``, MXNet's ``ndarray/random.py``), over
the registered ``random_*`` and ``sample_*`` ops. Draws come from the
device's generator (``mx.random.seed``)."""
from __future__ import annotations

from .register import get_op as _get_op
from .register import invoke as _invoke

__all__ = ["bernoulli", "exponential", "gamma", "multinomial",
           "negative_binomial", "normal", "poisson", "randint", "randn",
           "shuffle", "uniform"]


def uniform(low=0.0, high=1.0, shape=None, dtype="float32", ctx=None,
            out=None, **kwargs):
    return _invoke(_get_op("random_uniform"), [],
                   {"low": low, "high": high, "shape": shape,
                    "dtype": dtype}, out=out, ctx=ctx)


def normal(loc=0.0, scale=1.0, shape=None, dtype="float32", ctx=None,
           out=None, **kwargs):
    return _invoke(_get_op("random_normal"), [],
                   {"loc": loc, "scale": scale, "shape": shape,
                    "dtype": dtype}, out=out, ctx=ctx)


def randn(*shape, loc=0.0, scale=1.0, dtype="float32", ctx=None):
    return normal(loc, scale, shape, dtype, ctx)


def gamma(alpha=1.0, beta=1.0, shape=None, dtype="float32", ctx=None,
          out=None):
    return _invoke(_get_op("random_gamma"), [],
                   {"alpha": alpha, "beta": beta, "shape": shape,
                    "dtype": dtype}, out=out, ctx=ctx)


def exponential(scale=1.0, shape=None, dtype="float32", ctx=None, out=None):
    return _invoke(_get_op("random_exponential"), [],
                   {"lam": 1.0 / scale, "shape": shape, "dtype": dtype},
                   out=out, ctx=ctx)


def poisson(lam=1.0, shape=None, dtype="float32", ctx=None, out=None):
    return _invoke(_get_op("random_poisson"), [],
                   {"lam": lam, "shape": shape, "dtype": dtype}, out=out,
                   ctx=ctx)


def negative_binomial(k=1, p=1.0, shape=None, dtype="float32", ctx=None,
                      out=None):
    return _invoke(_get_op("random_negative_binomial"), [],
                   {"k": k, "p": p, "shape": shape, "dtype": dtype},
                   out=out, ctx=ctx)


def randint(low, high, shape=None, dtype="int32", ctx=None, out=None):
    return _invoke(_get_op("random_randint"), [],
                   {"low": low, "high": high, "shape": shape,
                    "dtype": dtype}, out=out, ctx=ctx)


def multinomial(data, shape=None, get_prob=False, dtype="int32", out=None):
    return _invoke(_get_op("sample_multinomial"), [data],
                   {"shape": shape, "get_prob": get_prob, "dtype": dtype},
                   out=out)


def shuffle(data, out=None):
    return _invoke(_get_op("shuffle"), [data], {}, out=out)


def bernoulli(prob=None, logit=None, shape=None, dtype="float32", ctx=None,
              out=None):
    inputs = [x for x in (prob, logit)
              if x is not None and not isinstance(x, (int, float))]
    params = {"shape": shape, "dtype": dtype}
    if not inputs:
        params["prob"] = prob
        params["logit"] = logit
    return _invoke(_get_op("bernoulli"), inputs, params, out=out, ctx=ctx)
