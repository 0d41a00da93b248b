"""``mx.sym.np``: the symbolic NumPy namespace (its op-backed part).

Port of ``mxnet_tpu/symbol/numpy.py`` (MXNet's
``python/mxnet/symbol/numpy/``): NumPy-style graphs over the registry
ops that eager ``mx.np`` dispatches. Every ``mx.np`` function that is
one registry op is here (the unaries, the binaries with Python scalars
lifted to ``_constant`` nodes, the reductions, the one-op
rearrangements, the contractions and ``linalg``), and the statically
shaped compositions (the split family, ``meshgrid``, the stack helpers,
``atleast_*``, ``broadcast_arrays``, ``interp``, ``around``,
``average``, ``quantile``/``percentile``) are ``_npi_*`` ops with real
output selectors. The functions whose output shape depends on the
values (``nonzero``, ``unique``, ``histogram``, ``bincount``,
``argwhere``) raise the JAX package's errors, pointing at eager
``mx.np``; any other name raises ``AttributeError`` pointing at
``hybridize``.
"""
from __future__ import annotations

import sys as _sys

from ..ndarray.register import get_op
from .symbol import Symbol, _make_node

__all__ = []


def _lift(x, ref_name):
    """Symbols pass through; python scalars become _constant nodes
    (symbolic graphs cannot hold runtime values). Scalar dtype follows
    the python type so integer ops (shifts/bitwise) stay integer and
    int arrays aren't silently promoted to float."""
    if isinstance(x, Symbol):
        return x
    if isinstance(x, bool):
        return _make_node(get_op("_constant"), [],
                          {"value": int(x), "dtype": "int32"}, name=None)
    if isinstance(x, int):
        return _make_node(get_op("_constant"), [],
                          {"value": x, "dtype": "int32"}, name=None)
    if isinstance(x, float):
        return _make_node(get_op("_constant"), [],
                          {"value": x, "dtype": "float32"}, name=None)
    raise TypeError(
        f"sym.np.{ref_name}: expected Symbol or python scalar, got "
        f"{type(x).__name__} (symbolic graphs cannot embed runtime "
        f"arrays — use mx.sym.zeros/ones/arange or hybridize)")


def _sfn(fname, opname, n_in=1, pos_params=()):
    """Build a symbolic np function: first ``n_in`` positionals are
    tensor inputs (scalar-lifted), further positionals bind to
    ``pos_params`` names, keywords pass through as op params."""

    def f(*args, name=None, **params):
        if len(args) < n_in:
            raise TypeError(
                f"sym.np.{fname} needs {n_in} tensor argument(s), "
                f"got {len(args)}")
        inputs = [_lift(a, fname) for a in args[:n_in]]
        extra = args[n_in:]
        if len(extra) > len(pos_params):
            raise TypeError(
                f"sym.np.{fname}: too many positional arguments")
        for pname, val in zip(pos_params, extra):
            params.setdefault(pname, val)
        return _make_node(get_op(opname), inputs, params, name=name)

    f.__name__ = fname
    f.__doc__ = f"Symbolic numpy.{fname}: registry op {opname}."
    return f


def _not_composable(fname):
    def f(*args, **kwargs):
        raise NotImplementedError(
            f"sym.np.{fname} is Python-composed in the eager frontend "
            f"and has no single-op symbolic lowering — hybridize the "
            f"block instead (the compiled path supports all of mx.np)")
    f.__name__ = fname
    return f


_mod = _sys.modules[__name__]


def _install(fname, fn):
    setattr(_mod, fname, fn)
    __all__.append(fname)


# unary + binary tables are shared with the eager frontend — the op
# mapping is the single source of truth
from ..numpy.multiarray import _UNARY_TABLE, _BINARY_TABLE  # noqa: E402

for _f, _o in _UNARY_TABLE.items():
    _install(_f, _sfn(_f, _o, n_in=1))
for _f, _o in _BINARY_TABLE.items():
    _install(_f, _sfn(_f, _o, n_in=2))

# reductions (axis/keepdims ride as params)
for _f, _o in {
    "sum": "sum", "mean": "mean", "prod": "prod", "max": "max",
    "min": "min", "amax": "max", "amin": "min", "nansum": "nansum",
    "nanprod": "nanprod", "cumsum": "cumsum",
    "std": "_npi_std", "var": "_npi_var", "median": "_npi_median",
    "ptp": "_npi_ptp", "all": "_npi_all", "any": "_npi_any",
    "count_nonzero": "_npi_count_nonzero", "cumprod": "_npi_cumprod",
    "nanmax": "_npi_nanmax", "nanmin": "_npi_nanmin",
    "nanmean": "_npi_nanmean", "diff": "_npi_diff",
}.items():
    _install(_f, _sfn(_f, _o, n_in=1, pos_params=("axis",)))

# manipulation (single-op)
_install("reshape", _sfn("reshape", "reshape", 1, ("shape",)))
_install("transpose", _sfn("transpose", "transpose", 1, ("axes",)))
_install("expand_dims", _sfn("expand_dims", "expand_dims", 1, ("axis",)))
_install("squeeze", _sfn("squeeze", "squeeze", 1, ("axis",)))
_install("broadcast_to", _sfn("broadcast_to", "_npi_broadcast_to", 1,
                              ("shape",)))
_install("tile", _sfn("tile", "tile", 1, ("reps",)))
_install("repeat", _sfn("repeat", "repeat", 1, ("repeats", "axis")))
_install("flip", _sfn("flip", "flip", 1, ("axis",)))
_install("roll", _sfn("roll", "_npi_roll", 1, ("shift", "axis")))
_install("rot90", _sfn("rot90", "_npi_rot90", 1, ("k", "axes")))
_install("moveaxis", _sfn("moveaxis", "_npi_moveaxis", 1,
                          ("source", "destination")))
_install("tril", _sfn("tril", "_npi_tril", 1, ("k",)))
_install("triu", _sfn("triu", "_npi_triu", 1, ("k",)))
_install("trace", _sfn("trace", "_npi_trace", 1,
                       ("offset", "axis1", "axis2")))
_install("diagonal", _sfn("diagonal", "_npi_diagonal", 1,
                          ("offset", "axis1", "axis2")))
_install("diagflat", _sfn("diagflat", "_npi_diagflat", 1, ("k",)))
_install("clip", _sfn("clip", "clip", 1, ("a_min", "a_max")))
_install("take", _sfn("take", "take", 2, ("axis",)))
_install("take_along_axis", _sfn("take_along_axis", "_npi_take_along_axis",
                                 2, ("axis",)))
_install("searchsorted", _sfn("searchsorted", "_npi_searchsorted", 2,
                              ("side",)))
_install("pad", _sfn("pad", "_npi_pad", 1, ("pad_width", "mode")))
_install("sort", _sfn("sort", "sort", 1, ("axis",)))
_install("argsort", _sfn("argsort", "argsort", 1, ("axis",)))
_install("argmax", _sfn("argmax", "argmax", 1, ("axis",)))
_install("argmin", _sfn("argmin", "argmin", 1, ("axis",)))


def where(condition, x, y, name=None):
    return _make_node(get_op("_npi_where"),
                      [_lift(condition, "where"), _lift(x, "where"),
                       _lift(y, "where")], {}, name=name)


_install("where", where)


def concatenate(seq, axis=0, name=None):
    syms = [_lift(s, "concatenate") for s in seq]
    if axis is None:
        # numpy: flatten every input first, then join along axis 0
        syms = [_make_node(get_op("reshape"), [s], {"shape": (-1,)})
                for s in syms]
        axis = 0
    return _make_node(get_op("concat"), syms, {"dim": axis}, name=name)


_install("concatenate", concatenate)


def stack(arrays, axis=0, name=None):
    return _make_node(get_op("stack"), [_lift(a, "stack") for a in arrays],
                      {"axis": axis}, name=name)


_install("stack", stack)

# contractions
_install("dot", _sfn("dot", "_npi_dot", 2))
_install("matmul", _sfn("matmul", "_npi_matmul", 2))
_install("inner", _sfn("inner", "_npi_inner", 2))
_install("outer", _sfn("outer", "_npi_outer", 2))
_install("vdot", _sfn("vdot", "_npi_vdot", 2))
_install("kron", _sfn("kron", "_npi_kron", 2))
_install("cross", _sfn("cross", "_npi_cross", 2, ("axis",)))
_install("tensordot", _sfn("tensordot", "_npi_tensordot", 2, ("axes",)))


def einsum(subscripts, *operands, name=None, **params):
    return _make_node(get_op("_npi_einsum"),
                      [_lift(o, "einsum") for o in operands],
                      {"subscripts": subscripts, **params}, name=name)


_install("einsum", einsum)

# one op each, but their output shape depends on the values, which a
# bound graph cannot hold: excluded with the JAX package's message
# (eager mx.np has them)
def _dynamic_shape(fname):
    def f(*args, **kwargs):
        raise NotImplementedError(
            f"sym.np.{fname}: output shape depends on VALUES "
            f"(dynamic), which symbolic graph execution cannot bind — "
            f"use eager mx.np.{fname}")
    f.__name__ = fname
    return f


for _f in ("argwhere",):
    _install(_f, _dynamic_shape(_f))

# compositions whose output shape depends on the values: a named
# error, not AttributeError
for _f in ("nonzero", "flatnonzero", "unique", "histogram", "bincount"):
    _install(_f, _not_composable(_f))


# statically shaped compositions lower to their own registry ops
# (numpy/ops.py's last section), with real output selectors for the
# multi-output ones (split, meshgrid, broadcast_arrays)
def _seq_fn(fname, opname):
    def f(seq, name=None):
        return _make_node(get_op(opname),
                          [_lift(s, fname) for s in seq], {}, name=name)
    f.__name__ = fname
    return f


for _f in ("vstack", "hstack", "dstack", "column_stack"):
    _install(_f, _seq_fn(_f, f"_npi_{_f}"))


def _split_fn(fname, axis_fixed=None):
    op = "_npi_array_split" if fname == "array_split" else "_npi_split_np"

    def f(ary, indices_or_sections, axis=0, name=None):
        if axis_fixed is not None and axis != 0:
            # numpy's vsplit/hsplit/dsplit take NO axis argument —
            # silently splitting on the fixed axis anyway would discard
            # the caller's intent
            raise TypeError(f"sym.np.{fname} does not accept axis "
                            f"(it always splits axis {axis_fixed})")
        ios = (tuple(int(i) for i in indices_or_sections)
               if isinstance(indices_or_sections, (list, tuple))
               else int(indices_or_sections))
        return _make_node(get_op(op), [_lift(ary, fname)],
                          {"indices_or_sections": ios,
                           "axis": axis_fixed if axis_fixed is not None
                           else axis}, name=name)
    f.__name__ = fname
    if axis_fixed is not None and axis_fixed > 0:
        f.__doc__ = (f"Symbolic numpy.{fname}; assumes input rank > "
                     f"{axis_fixed} (symbols carry no rank).")
    return f


_install("split", _split_fn("split"))
_install("array_split", _split_fn("array_split"))
_install("vsplit", _split_fn("vsplit", axis_fixed=0))
_install("hsplit", _split_fn("hsplit", axis_fixed=1))
_install("dsplit", _split_fn("dsplit", axis_fixed=2))


def meshgrid(*xi, indexing="xy", name=None):
    return _make_node(get_op("_npi_meshgrid"),
                      [_lift(x, "meshgrid") for x in xi],
                      {"indexing": indexing, "num_outputs": len(xi)},
                      name=name)


_install("meshgrid", meshgrid)


def broadcast_arrays(*args, name=None):
    return _make_node(get_op("_npi_broadcast_arrays"),
                      [_lift(a, "broadcast_arrays") for a in args],
                      {"num_outputs": len(args)}, name=name)


_install("broadcast_arrays", broadcast_arrays)

for _f in ("atleast_1d", "atleast_2d", "atleast_3d"):
    _install(_f, _sfn(_f, f"_npi_{_f}", 1))
_install("interp", _sfn("interp", "_npi_interp", 3, ("left", "right")))
_install("around", _sfn("around", "_npi_around", 1, ("decimals",)))
_install("quantile", _sfn("quantile", "_npi_quantile", 1, ("q", "axis")))
_install("percentile", _sfn("percentile", "_npi_percentile", 1,
                            ("q", "axis")))


def average(a, axis=None, weights=None, name=None):
    inputs = [_lift(a, "average")]
    if weights is not None:
        inputs.append(_lift(weights, "average"))
    return _make_node(get_op("_npi_average"), inputs, {"axis": axis},
                      name=name)


_install("average", average)


def __getattr__(attr):
    """Unknown names raise AttributeError carrying the pointer-at-
    hybridize message (eager mx.np has many functions with no single-op
    symbolic lowering — creation fns, composed helpers). AttributeError
    — not NotImplementedError — so hasattr()/getattr(..., default)
    introspection keeps working."""
    raise AttributeError(
        f"sym.np.{attr} has no symbolic lowering — hybridize the block "
        f"instead (the compiled path supports all of mx.np), or use "
        f"mx.sym.zeros/ones/arange for symbolic creation")


class _SymLinalg:
    """sym.np.linalg — symbolic lowering of the _npi linalg ops."""

    norm = staticmethod(_sfn("norm", "_npi_norm", 1, ("ord", "axis")))
    svd = staticmethod(_sfn("svd", "_npi_svd", 1))
    inv = staticmethod(_sfn("inv", "_npi_inv", 1))
    pinv = staticmethod(_sfn("pinv", "_npi_pinv", 1, ("rcond",)))
    det = staticmethod(_sfn("det", "_npi_det", 1))
    slogdet = staticmethod(_sfn("slogdet", "_npi_slogdet", 1))
    eigh = staticmethod(_sfn("eigh", "_npi_eigh", 1))
    eigvalsh = staticmethod(_sfn("eigvalsh", "_npi_eigvalsh", 1))
    qr = staticmethod(_sfn("qr", "_npi_qr", 1))
    cholesky = staticmethod(_sfn("cholesky", "_npi_cholesky", 1))
    solve = staticmethod(_sfn("solve", "_npi_solve", 2))
    matrix_power = staticmethod(_sfn("matrix_power", "_npi_matrix_power",
                                     1, ("n",)))


linalg = _SymLinalg()
__all__.append("linalg")
