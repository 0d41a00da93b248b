"""``mx.np.linalg``: NumPy's linear-algebra namespace.

Port of ``mxnet_tpu/numpy/linalg.py``. Each function dispatches an
``_npi_*`` op of ``numpy/ops.py`` over ``torch.linalg`` (cuSOLVER and
cuBLAS on the card; no Pallas kernel lies here). The classic
``mx.nd.linalg_*`` ops stay the BLAS-style surface."""
from __future__ import annotations

from .multiarray import _np_invoke, _proc, _procs

__all__ = ["norm", "svd", "inv", "pinv", "det", "slogdet", "eigh",
           "eigvalsh", "qr", "cholesky", "solve", "lstsq", "matrix_power",
           "matrix_rank", "multi_dot"]


def norm(x, ord=None, axis=None, keepdims=False):  # noqa: A002
    return _np_invoke("_npi_norm", [_proc(x)],
                      {"ord": ord, "axis": axis, "keepdims": keepdims})


def svd(a, full_matrices=False):
    return tuple(_np_invoke("_npi_svd", [_proc(a)],
                            {"full_matrices": full_matrices}))


def inv(a):
    return _np_invoke("_npi_inv", [_proc(a)])


def pinv(a, rcond=1e-15):
    return _np_invoke("_npi_pinv", [_proc(a)], {"rcond": rcond})


def det(a):
    return _np_invoke("_npi_det", [_proc(a)])


def slogdet(a):
    return tuple(_np_invoke("_npi_slogdet", [_proc(a)]))


def eigh(a, UPLO="L"):
    return tuple(_np_invoke("_npi_eigh", [_proc(a)], {"UPLO": UPLO}))


def eigvalsh(a, UPLO="L"):
    return _np_invoke("_npi_eigvalsh", [_proc(a)], {"UPLO": UPLO})


def qr(a, mode="reduced"):
    return tuple(_np_invoke("_npi_qr", [_proc(a)], {"mode": mode}))


def cholesky(a):
    return _np_invoke("_npi_cholesky", [_proc(a)])


def solve(a, b):
    return _np_invoke("_npi_solve", _procs(a, b))


def lstsq(a, b, rcond=None):
    return tuple(_np_invoke("_npi_lstsq", _procs(a, b), {"rcond": rcond}))


def matrix_power(a, n):
    return _np_invoke("_npi_matrix_power", [_proc(a)], {"n": n})


def matrix_rank(a, tol=None):
    return _np_invoke("_npi_matrix_rank", [_proc(a)], {"tol": tol})


def multi_dot(arrays):
    return _np_invoke("_npi_multi_dot", _procs(*arrays))
