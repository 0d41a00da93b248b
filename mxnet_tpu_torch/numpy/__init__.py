"""``mx.np``: the NumPy-compatible frontend of the PyTorch port.

Port of ``mxnet_tpu/numpy/`` (MXNet's deep NumPy,
``python/mxnet/numpy/``): NumPy's semantics (zero-dim arrays, boolean
masks, NumPy's broadcasting and signatures) over the same registry,
autograd and kernels as the classic ``mx.nd``. ``multiarray`` holds the
array type and the functions, ``ops`` the ``_npi_*`` operators,
``linalg`` and ``random`` the sub-namespaces."""
from __future__ import annotations

import numpy as _onp

from .multiarray import *  # noqa: F401,F403
from .multiarray import __all__ as _ma_all
from . import linalg  # noqa: F401
from . import random  # noqa: F401

# dtype aliases: numpy's own, as MXNet's ``mx.np.float32`` is
# ``numpy.float32`` (bfloat16, which numpy lacks, by name)
float16 = _onp.float16
float32 = _onp.float32
float64 = _onp.float64
bfloat16 = "bfloat16"
int8 = _onp.int8
int16 = _onp.int16
int32 = _onp.int32
int64 = _onp.int64
uint8 = _onp.uint8
uint16 = _onp.uint16
uint32 = _onp.uint32
uint64 = _onp.uint64
bool_ = _onp.bool_
dtype = _onp.dtype

# constants
pi = _onp.pi
e = _onp.e
euler_gamma = _onp.euler_gamma
inf = _onp.inf
nan = _onp.nan
newaxis = None
PZERO = 0.0
NZERO = -0.0

__all__ = list(_ma_all) + [
    "linalg", "random", "float16", "float32", "float64", "bfloat16",
    "int8", "int16", "int32", "int64", "uint8", "uint16", "uint32",
    "uint64", "bool_", "dtype", "pi", "e", "euler_gamma", "inf", "nan",
    "newaxis",
]
