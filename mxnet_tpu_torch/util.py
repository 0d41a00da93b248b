"""Small utilities (port of ``mxnet_tpu/util.py``, MXNet's
``util.py``): the numpy-semantics flags (``set_np``, ``is_np_array``,
``is_np_shape``, ``reset_np``, the scoped :class:`np_scope` and the
:func:`use_np` decorator), :func:`makedirs` and :func:`getenv`. With
``set_np()`` (``array=True``) on, the arrays the classic frontend and
Gluon give back are ``mx.np.ndarray``s (``ndarray.wrap_cls``)."""
from __future__ import annotations

import functools
import inspect
import os

__all__ = ["getenv", "is_np_array", "is_np_shape", "makedirs", "np_scope",
           "reset_np", "set_np", "use_np"]

_FLAGS = {"array": False, "shape": False}


def is_np_array():
    return _FLAGS["array"]


def is_np_shape():
    return _FLAGS["shape"]


def set_np(shape=True, array=True):
    _FLAGS["array"], _FLAGS["shape"] = bool(array), bool(shape)


def reset_np():
    set_np(False, False)


class np_scope:
    """Numpy semantics on inside, the previous flags back on exit."""

    def __enter__(self):
        self._saved = dict(_FLAGS)
        set_np()
        return self

    def __exit__(self, *exc):
        _FLAGS.update(self._saved)
        return False


def use_np(func):
    """Run ``func`` (or a class's ``__init__``/``__call__``/``forward``/
    ``hybrid_forward``) inside :class:`np_scope`."""
    if inspect.isclass(func):
        for name in ("__init__", "__call__", "forward", "hybrid_forward"):
            m = func.__dict__.get(name)
            if m is not None and callable(m):
                setattr(func, name, use_np(m))
        return func

    @functools.wraps(func)
    def wrapped(*args, **kwargs):
        with np_scope():
            return func(*args, **kwargs)

    return wrapped


def makedirs(d):
    os.makedirs(d, exist_ok=True)


def getenv(name, default=None):
    return os.environ.get(name, default)
