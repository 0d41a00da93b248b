"""``mx.sym.random``: symbolic samplers (port of
``mxnet_tpu/symbol/random.py``). A bound graph draws from its device's
generator (``mx.random``)."""
from __future__ import annotations

from ..ndarray.register import get_op
from .symbol import _make_node


def uniform(low=0.0, high=1.0, shape=None, dtype="float32", name=None,
            **kwargs):
    return _make_node(get_op("random_uniform"), [],
                      {"low": low, "high": high, "shape": shape,
                       "dtype": dtype}, name=name)


def normal(loc=0.0, scale=1.0, shape=None, dtype="float32", name=None,
           **kwargs):
    return _make_node(get_op("random_normal"), [],
                      {"loc": loc, "scale": scale, "shape": shape,
                       "dtype": dtype}, name=name)
