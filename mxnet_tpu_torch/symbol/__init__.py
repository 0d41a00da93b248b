"""``mx.sym``: the symbolic API of the PyTorch port.

Port of ``mxnet_tpu/symbol/__init__.py``: :class:`Symbol`,
:func:`Variable`/:func:`var`, :func:`Group`, :func:`load`/:func:`load_json`
and one builder ``mx.sym.<op>`` per op of the port's registry
(``ndarray/register.py``), generated at import. A name of the JAX
registry that is not ported yet (``mx.nd.WAITING``) raises
``NotImplementedError`` naming its ROADMAP item, as ``mx.nd.<name>``
does. Sub-namespaces: ``random``, ``linalg``, ``sparse``, ``contrib``;
``symbol/numpy.py`` and ``numpy_extension.py`` wait with the numpy
frontend.
"""
import sys as _sys

from .symbol import (Group, Symbol, Variable, _populate_symbol_ops,  # noqa
                     arange, load, load_json, ones, var, zeros)

_populate_symbol_ops(_sys.modules[__name__])


def __getattr__(name):
    from .symbol import _refuse_waiting
    _refuse_waiting(name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


from . import contrib, linalg, random, sparse  # noqa: E402
