"""``mx.sym.sparse`` (port of ``mxnet_tpu/symbol/sparse.py``): in a
bound graph every array is dense, as in the JAX package's."""
from __future__ import annotations

from ..ndarray.register import get_op
from .symbol import _make_node


def dot(lhs, rhs, transpose_a=False, transpose_b=False, name=None):
    return _make_node(get_op("dot"), [lhs, rhs],
                      {"transpose_a": transpose_a, "transpose_b": transpose_b},
                      name=name)


def retain(data, indices, name=None):
    return _make_node(get_op("take"), [data, indices], {"axis": 0}, name=name)
