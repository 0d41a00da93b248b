"""``mx.nd.linalg`` (port of ``mxnet_tpu/ndarray/linalg.py``, MXNet's
``la_op.cc`` surface) over the registered ``linalg_*`` ops."""
from __future__ import annotations

from .register import get_op as _get_op
from .register import invoke as _invoke

__all__ = ["extractdiag", "gemm", "gemm2", "potrf", "sumlogdiag", "syrk",
           "trsm"]


def gemm(A, B, C, transpose_a=False, transpose_b=False, alpha=1.0,
         beta=1.0, axis=-2):
    return _invoke(_get_op("linalg_gemm"), [A, B, C],
                   {"transpose_a": transpose_a, "transpose_b": transpose_b,
                    "alpha": alpha, "beta": beta})


def gemm2(A, B, transpose_a=False, transpose_b=False, alpha=1.0, axis=-2):
    return _invoke(_get_op("linalg_gemm2"), [A, B],
                   {"transpose_a": transpose_a, "transpose_b": transpose_b,
                    "alpha": alpha})


def potrf(A):
    return _invoke(_get_op("linalg_potrf"), [A])


def trsm(A, B, transpose=False, rightside=False, lower=True, alpha=1.0):
    return _invoke(_get_op("linalg_trsm"), [A, B],
                   {"transpose": transpose, "rightside": rightside,
                    "lower": lower, "alpha": alpha})


def sumlogdiag(A):
    return _invoke(_get_op("linalg_sumlogdiag"), [A])


def extractdiag(A, offset=0):
    return _invoke(_get_op("linalg_extractdiag"), [A], {"offset": offset})


def syrk(A, transpose=False, alpha=1.0):
    return _invoke(_get_op("linalg_syrk"), [A],
                   {"transpose": transpose, "alpha": alpha})
