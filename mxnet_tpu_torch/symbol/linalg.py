"""``mx.sym.linalg`` (port of ``mxnet_tpu/symbol/linalg.py``)."""
from __future__ import annotations

from ..ndarray.register import get_op
from .symbol import _make_node


def gemm(A, B, C, transpose_a=False, transpose_b=False, alpha=1.0, beta=1.0,
         name=None):
    return _make_node(get_op("linalg_gemm"), [A, B, C],
                      {"transpose_a": transpose_a, "transpose_b": transpose_b,
                       "alpha": alpha, "beta": beta}, name=name)


def gemm2(A, B, transpose_a=False, transpose_b=False, alpha=1.0, name=None):
    return _make_node(get_op("linalg_gemm2"), [A, B],
                      {"transpose_a": transpose_a, "transpose_b": transpose_b,
                       "alpha": alpha}, name=name)


def potrf(A, name=None):
    return _make_node(get_op("linalg_potrf"), [A], {}, name=name)
