"""``mx.np``: the NumPy-compatible array type and its functions.

Port of ``mxnet_tpu/numpy/multiarray.py`` (MXNet's deep NumPy,
``python/mxnet/numpy/multiarray.py``): :class:`ndarray` has NumPy's
semantics (zero-dim arrays, boolean masks, bool comparisons, NumPy's
signatures) on the classic runtime. Every function dispatches a
registered op (a classic one where it computes the function, an
``_npi_*`` one of ``numpy/ops.py`` otherwise), so autograd, AMP's cast
hook and ``mx.sym.np`` see np-mode work as they see classic work.

**The type.** :class:`ndarray` is an :class:`~..ndarray.NDArray`, so a
``torch.Tensor`` subclass. Torch's own ops on it give ``ndarray``s
(its ``__torch_function__``); the methods whose NumPy meaning differs
from torch's are NumPy's here: ``reshape`` (MXNet's codes kept, as the
JAX package's), ``sum``/``mean``/``max``/``min``/``prod`` (``axis=``,
arrays out), ``std``/``var`` (``ddof=0``), ``sort`` (in place),
``argsort``, ``nonzero`` (a tuple), ``take`` (flat by default),
``transpose(*axes)``, ``squeeze(axis)``, ``cumsum(axis=None)``,
``round(decimals)``, ``flatten`` (a raveled copy), ``dtype`` (numpy's:
``x.dtype == np.float32``; bfloat16, which numpy lacks, stays torch's)
and ``size`` (an int, which torch's code may still call as ``size()``).
Comparisons give bool arrays. The port's layers, kernels, optimizers
and CUDA graphs never see the type: the Gluon boundary and the registry
unwrap to plain tensors, and ``autograd.backward`` gives torch plain
heads.

**Which arrays are ``ndarray``s.** ``mx.np``'s functions return them
for array inputs; given only plain tensors (inside a
``hybrid_forward``, where ``F.np`` is this module) they return plain
tensors, as every registry op does. ``npx.set_np()`` makes the classic
frontend's outputs, loaders, parameters' ``data()``/``grad()`` and
Gluon's outputs ``ndarray``s too (``ndarray.wrap_cls``), and a classic
op given one returns one. ``as_np_ndarray``/``as_nd_ndarray`` share the
storage and stay on the tape under ``autograd.record()``.

**Types of results** follow the JAX package (``numpy/ops.py``): Python
floats and float64 data become float32, integer true division gives
float32.
"""
from __future__ import annotations

import numpy as onp
import torch

from ..context import resolve_device
from ..ndarray import ndarray as _ndmod
from ..ndarray.ndarray import NDArray, _tdtype, to_dtype
from ..ndarray.register import get_op, invoke
from . import ops as _ops  # noqa: F401  (registers the _npi_* family)

__all__ = [
    "ndarray", "array", "asarray", "zeros", "ones", "empty", "full",
    "zeros_like", "ones_like", "full_like", "empty_like", "arange",
    "linspace", "logspace", "eye", "identity", "meshgrid", "tril", "triu",
    "diag", "diagflat", "diagonal", "trace", "copy",
    # manipulation
    "reshape", "ravel", "transpose", "moveaxis", "swapaxes", "concatenate",
    "stack", "vstack", "hstack", "dstack", "column_stack", "split",
    "array_split", "hsplit", "vsplit", "expand_dims", "squeeze",
    "broadcast_to", "broadcast_arrays", "tile", "repeat", "flip", "fliplr",
    "flipud", "roll", "rot90", "pad", "append", "where", "take",
    "take_along_axis", "clip", "nonzero", "flatnonzero", "unique", "sort",
    "argsort", "argmax", "argmin", "searchsorted", "atleast_1d",
    "atleast_2d", "atleast_3d", "insert_dims_like",
    # math
    "add", "subtract", "multiply", "divide", "true_divide", "floor_divide",
    "mod", "remainder", "fmod", "power", "maximum", "minimum", "fmax",
    "fmin", "hypot", "arctan2", "logaddexp", "logaddexp2", "copysign",
    "ldexp", "heaviside", "gcd", "lcm", "bitwise_and", "bitwise_or",
    "bitwise_xor", "invert", "bitwise_not", "left_shift", "right_shift",
    "logical_and", "logical_or", "logical_xor", "logical_not", "equal",
    "not_equal", "greater", "greater_equal", "less", "less_equal",
    # reductions
    "sum", "prod", "mean", "std", "var", "median", "quantile", "percentile",
    "average", "min", "max", "amin", "amax", "nanmin", "nanmax", "nanmean",
    "nansum", "nanprod", "cumsum", "cumprod", "all", "any", "count_nonzero",
    "ptp", "diff", "bincount", "histogram", "around", "round", "round_",
    # contractions
    "dot", "vdot", "inner", "outer", "matmul", "tensordot", "einsum",
    "kron", "cross",
    # logic / misc
    "isclose", "allclose", "array_equal", "interp", "ediff1d",
    "nan_to_num", "shape", "size", "ndim", "may_share_memory",
    "result_type", "promote_types", "finfo", "iinfo", "isnan", "isinf",
    "isfinite", "signbit",
]

# numpy's dtype of each torch dtype (bfloat16 has none and stays torch's)
_NP_DTYPE = {t: onp.dtype(n) for t, n in (
    (torch.float32, "float32"), (torch.float64, "float64"),
    (torch.float16, "float16"), (torch.uint8, "uint8"),
    (torch.int8, "int8"), (torch.int16, "int16"), (torch.int32, "int32"),
    (torch.int64, "int64"), (torch.bool, "bool"),
    (torch.uint16, "uint16"), (torch.uint32, "uint32"),
    (torch.uint64, "uint64"))}


def np_dtype(dt):
    """numpy's dtype for a torch one (bfloat16: torch's)."""
    return _NP_DTYPE.get(dt, dt)


def _np_invoke(name, inputs, params=None, out=None):
    """Dispatch a registry op; array outputs are ``mx.np.ndarray``s
    (plain tensors when every input is one: module docstring)."""
    return invoke(get_op(name), inputs, params, out=out, wrap_cls=ndarray)


def _device(xs):
    for x in xs:
        if isinstance(x, torch.Tensor):
            return x.device
    return None


def _proc(x, like=None):
    """A function argument as ``invoke`` takes it: tensors, scalars and
    None as they are, lists and numpy data as an ``ndarray`` on the
    device of ``like`` (a tensor, or a list to search), else the
    current context's."""
    if isinstance(x, torch.Tensor) or x is None or \
            isinstance(x, (bool, int, float)):
        return x
    if isinstance(x, onp.generic):
        return x.item()
    if isinstance(like, (list, tuple)):
        like = _device(like)
    elif isinstance(like, torch.Tensor):
        like = like.device
    return array(x, ctx=like)


def _procs(*xs):
    dev = _device(xs)
    return [_proc(x, dev) for x in xs]


def _new(t):
    return t.as_subclass(ndarray)


class _Size(int):
    """NumPy's ``ndarray.size``, an int, which torch's own code may
    still call as ``size()``/``size(dim)``."""

    def __new__(cls, t):
        obj = int.__new__(cls, t.numel())
        obj._shape = torch.Tensor.size(t)
        return obj

    def __call__(self, dim=None):
        return self._shape if dim is None else self._shape[dim]


# ---------------------------------------------------------------------------
# the ndarray type
# ---------------------------------------------------------------------------
class ndarray(NDArray):
    """NumPy-semantics array (``mx.np.ndarray``; module docstring)."""

    @property
    def dtype(self):
        return np_dtype(_tdtype(self))

    @property
    def size(self):
        return _Size(self)

    def __repr__(self, *, tensor_contents=None):
        a = self.asnumpy()
        body = onp.array2string(a, separator=", ")
        dt = _tdtype(self)
        dts = "" if dt == torch.float32 else f", dtype={np_dtype(dt)}"
        ctx = "" if self.device.type == "cpu" else f", ctx={self.context}"
        return f"array({body}{dts}{ctx})"

    def __format__(self, spec):
        if self.ndim == 0:
            return format(self.item(), spec)
        return format(repr(self), spec)

    # -- conversion ------------------------------------------------------
    def as_np_ndarray(self):
        return self

    def tolist(self):
        return self.asnumpy().tolist()

    def item(self, *args):
        a = self.asnumpy()
        return a.item(*args) if args else a.item()

    # -- NumPy-signature methods -----------------------------------------
    def reshape(self, *shape, **kwargs):
        if len(shape) == 1 and isinstance(shape[0], (tuple, list)):
            shape = tuple(shape[0])
        shape = tuple(kwargs.get("shape", kwargs.get("newshape", shape)))
        return _np_invoke("reshape", [self], {"shape": shape})

    def flatten(self, order="C"):
        # NumPy's flatten: a raveled copy, not the classic (N, -1)
        return self.reshape(-1)

    def ravel(self, order="C"):
        return self.reshape(-1)

    def mean(self, axis=None, dtype=None, keepdims=False, **kw):
        return _method("mean", self, axis, keepdims, kw, dtype)

    def std(self, axis=None, ddof=0, keepdims=False, **kw):
        return _method("_npi_std", self, axis, keepdims, kw, ddof=ddof)

    def var(self, axis=None, ddof=0, keepdims=False, **kw):
        return _method("_npi_var", self, axis, keepdims, kw, ddof=ddof)

    def all(self, axis=None, keepdims=False, **kw):
        return _method("_npi_all", self, axis, keepdims, kw)

    def any(self, axis=None, keepdims=False, **kw):
        return _method("_npi_any", self, axis, keepdims, kw)

    def cumsum(self, axis=None, dtype=None, **kw):
        r = _np_invoke("cumsum", [self], {"axis": kw.pop("dim", axis)})
        return r.astype(dtype) if dtype is not None else r

    def round(self, decimals=0):
        return around(self, decimals)

    def clip(self, min=None, max=None):  # noqa: A002
        return clip(self, min, max)

    def take(self, indices, axis=None, mode="clip"):
        return take(self, indices, axis=axis, mode=mode)

    def nonzero(self):
        return nonzero(self)

    def dot(self, b):
        return dot(self, b)

    def argmax(self, axis=None, **kw):
        return _method("argmax", self, axis, False, kw)

    def argmin(self, axis=None, **kw):
        return _method("argmin", self, axis, False, kw)

    def sort(self, axis=-1):
        """In place, by NumPy's convention (through the registry op)."""
        r = _np_invoke("sort", [self], {"axis": axis, "is_ascend": True})
        with torch.no_grad():
            torch.Tensor.copy_(self, r)

    def argsort(self, axis=-1):
        return _np_invoke("argsort", [self], {"axis": axis,
                                              "is_ascend": True})

    def squeeze(self, axis=None):
        return _np_invoke("squeeze", [self], {"axis": axis})

    def transpose(self, *axes):
        if len(axes) == 1 and isinstance(axes[0], (tuple, list)):
            axes = tuple(axes[0])
        return _np_invoke("transpose", [self], {"axes": axes or None})

    def sum(self, axis=None, dtype=None, keepdims=False, **kw):
        return _method("sum", self, axis, keepdims, kw, dtype)

    def prod(self, axis=None, keepdims=False, **kw):
        return _method("prod", self, axis, keepdims, kw)

    def max(self, axis=None, keepdims=False, **kw):
        return _method("max", self, axis, keepdims, kw)

    def min(self, axis=None, keepdims=False, **kw):
        return _method("min", self, axis, keepdims, kw)


def _method(name, x, axis, keepdims, kw, dtype=None, **params):
    """A reduction method; the port's own code may call it torch's way,
    so ``dim``/``keepdim`` read as ``axis``/``keepdims``."""
    axis = kw.pop("dim", axis)
    keepdims = kw.pop("keepdim", keepdims)
    if kw:
        raise TypeError(f"{name}() got unexpected arguments {sorted(kw)}")
    if name not in ("argmax", "argmin") or keepdims:
        params["keepdims"] = keepdims
    r = _np_invoke(name, [x], {"axis": axis, **params})
    return r.astype(dtype) if dtype is not None else r


_ndmod._NP_CLS = ndarray


# ---------------------------------------------------------------------------
# creation
# ---------------------------------------------------------------------------
def _dev(ctx):
    return resolve_device(ctx)


def array(object, dtype=None, ctx=None):  # noqa: A002
    """An ``ndarray`` of ``object``; a tensor keeps its device unless
    ``ctx`` is given, Python floats and float64 data become float32."""
    dt = to_dtype(dtype)
    if isinstance(object, torch.Tensor):
        t = object.detach().as_subclass(torch.Tensor)
        dev = t.device if ctx is None else _dev(ctx)
        return _new(t.to(device=dev, dtype=dt or t.dtype, copy=True))
    a = onp.asarray(object)
    if dt is None:
        dt = torch.float32 if a.dtype == onp.float64 else to_dtype(a.dtype)
    return _new(torch.from_numpy(onp.array(a, order="C")).to(
        device=_dev(ctx), dtype=dt))


def asarray(a, dtype=None, ctx=None):
    if isinstance(a, ndarray) and dtype is None and ctx is None:
        return a
    return array(a, dtype=dtype, ctx=ctx)


def _shape(shape):
    return (shape,) if isinstance(shape, int) else tuple(shape)


def zeros(shape, dtype=None, ctx=None):
    return _new(torch.zeros(_shape(shape),
                            dtype=to_dtype(dtype) or torch.float32,
                            device=_dev(ctx)))


def ones(shape, dtype=None, ctx=None):
    return _new(torch.ones(_shape(shape),
                           dtype=to_dtype(dtype) or torch.float32,
                           device=_dev(ctx)))


def empty(shape, dtype=None, ctx=None):
    return zeros(shape, dtype, ctx)


def full(shape, fill_value, dtype=None, ctx=None):
    if dtype is None:
        dtype = onp.asarray(fill_value).dtype if isinstance(
            fill_value, (bool, int)) else "float32"
    return _new(torch.full(_shape(shape), fill_value,
                           dtype=to_dtype(dtype), device=_dev(ctx)))


def zeros_like(a, dtype=None):
    r = _np_invoke("zeros_like", [_proc(a)])
    return r.astype(dtype) if dtype is not None else r


def ones_like(a, dtype=None):
    r = _np_invoke("ones_like", [_proc(a)])
    return r.astype(dtype) if dtype is not None else r


def full_like(a, fill_value, dtype=None):
    r = _np_invoke("_full_like", [_proc(a)], {"value": fill_value})
    return r.astype(dtype) if dtype is not None else r


def empty_like(a, dtype=None):
    return zeros_like(a, dtype)


def _host(a, ctx, dtype=None):
    """An ``ndarray`` of numpy data ``a``: float64 as float32 unless
    ``dtype`` says otherwise."""
    if dtype is None and a.dtype == onp.float64:
        a = a.astype(onp.float32)
    return array(a, dtype=dtype, ctx=ctx)


def arange(start, stop=None, step=1, dtype=None, ctx=None):
    if stop is None:
        start, stop = 0, start
    dt = to_dtype(dtype)
    if dt is None and isinstance(start, int) and isinstance(stop, int) \
            and isinstance(step, int):
        dt = torch.int64
    return _new(torch.arange(start, stop, step, dtype=dt or torch.float32,
                             device=_dev(ctx)))


def linspace(start, stop, num=50, endpoint=True, retstep=False, dtype=None,
             axis=0, ctx=None):
    r = onp.linspace(start, stop, num, endpoint=endpoint, retstep=retstep,
                     dtype=dtype and onp.dtype(dtype), axis=axis)
    if retstep:
        return _host(r[0], ctx, dtype), float(r[1])
    return _host(r, ctx, dtype)


def logspace(start, stop, num=50, endpoint=True, base=10.0, dtype=None,
             ctx=None):
    return _host(onp.logspace(start, stop, num, endpoint=endpoint, base=base,
                              dtype=dtype and onp.dtype(dtype)), ctx, dtype)


def eye(N, M=None, k=0, dtype="float32", ctx=None):
    return _host(onp.eye(N, M, k=k, dtype=onp.dtype(dtype)), ctx, dtype)


def identity(n, dtype="float32", ctx=None):
    return eye(n, dtype=dtype, ctx=ctx)


def meshgrid(*xi, indexing="xy"):
    """Composed from registry ops (reshape + broadcast_to), so
    gradients flow."""
    xs = [asarray(x) for x in xi]
    n = len(xs)
    if n == 1:
        return [xs[0].reshape(-1)]
    lens = [int(x.size) for x in xs]
    pos = list(range(n))
    if indexing == "xy":
        pos[0], pos[1] = 1, 0
    dims = [0] * n
    for i, p in enumerate(pos):
        dims[p] = lens[i]
    outs = []
    for i, x in enumerate(xs):
        shp = [1] * n
        shp[pos[i]] = -1
        outs.append(broadcast_to(x.reshape(-1).reshape(tuple(shp)),
                                 tuple(dims)))
    return outs


def tril(a, k=0):
    return _np_invoke("_npi_tril", [_proc(a)], {"k": k})


def triu(a, k=0):
    return _np_invoke("_npi_triu", [_proc(a)], {"k": k})


def diag(v, k=0):
    return _np_invoke("diag", [_proc(v)], {"k": k})


def diagflat(v, k=0):
    return _np_invoke("_npi_diagflat", [_proc(v)], {"k": k})


def diagonal(a, offset=0, axis1=0, axis2=1):
    return _np_invoke("_npi_diagonal", [_proc(a)],
                      {"offset": offset, "axis1": axis1, "axis2": axis2})


def trace(a, offset=0, axis1=0, axis2=1):
    return _np_invoke("_npi_trace", [_proc(a)],
                      {"offset": offset, "axis1": axis1, "axis2": axis2})


def copy(a):
    return _np_arg(a).copy()


# ---------------------------------------------------------------------------
# manipulation
# ---------------------------------------------------------------------------
def _np_arg(x):
    """``x`` as an ``mx.np.ndarray``: functions that call its methods
    keep the np-out contract for classic inputs."""
    if isinstance(x, ndarray):
        return x
    if isinstance(x, torch.Tensor):
        return x.as_subclass(ndarray)
    return array(x)


def reshape(a, newshape, order="C"):
    return _np_arg(a).reshape(newshape)


def ravel(a, order="C"):
    return _np_arg(a).reshape(-1)


def transpose(a, axes=None):
    return _np_arg(a).transpose(*(axes or ()))


def moveaxis(a, source, destination):
    return _np_invoke("_npi_moveaxis", [_proc(a)],
                      {"source": source, "destination": destination})


def swapaxes(a, axis1, axis2):
    return _np_invoke("swapaxes", [_proc(a)], {"dim1": axis1, "dim2": axis2})


def concatenate(seq, axis=0, out=None):
    arrs = _procs(*seq)
    if axis is None:
        arrs = [_np_arg(a).reshape(-1) for a in arrs]
        axis = 0
    return _np_invoke("concat", arrs, {"dim": axis}, out=out)


def stack(arrays, axis=0, out=None):
    return _np_invoke("stack", _procs(*arrays), {"axis": axis}, out=out)


def vstack(tup):
    return concatenate([atleast_2d(a) for a in tup], axis=0)


def hstack(tup):
    arrs = [atleast_1d(a) for a in tup]
    if arrs and arrs[0].ndim == 1:
        return concatenate(arrs, axis=0)
    return concatenate(arrs, axis=1)


def dstack(tup):
    return concatenate([atleast_3d(a) for a in tup], axis=2)


def column_stack(tup):
    arrs = []
    for a in tup:
        a = atleast_1d(a)
        if a.ndim < 2:
            a = a.reshape(-1, 1)
        arrs.append(a)
    return concatenate(arrs, axis=1)


def _split_points(n, indices_or_sections, even_required):
    if isinstance(indices_or_sections, int):
        k = indices_or_sections
        if even_required and n % k != 0:
            raise ValueError("array split does not result in an equal "
                             "division")
        base, extra = divmod(n, k)
        pts, acc = [], 0
        for i in range(k - 1):
            acc += base + (1 if i < extra else 0)
            pts.append(acc)
        return pts
    return list(indices_or_sections)


def _split_impl(a, indices_or_sections, axis, even_required):
    a = _proc(a)
    n = a.shape[axis]
    pts = [0] + _split_points(n, indices_or_sections, even_required) + [n]
    return [_np_invoke("slice_axis", [a], {"axis": axis, "begin": b,
                                           "end": e})
            for b, e in zip(pts[:-1], pts[1:])]


def split(ary, indices_or_sections, axis=0):
    return _split_impl(ary, indices_or_sections, axis, even_required=True)


def array_split(ary, indices_or_sections, axis=0):
    return _split_impl(ary, indices_or_sections, axis, even_required=False)


def hsplit(ary, indices_or_sections):
    a = _proc(ary)
    return _split_impl(a, indices_or_sections, 0 if a.ndim == 1 else 1, True)


def vsplit(ary, indices_or_sections):
    return _split_impl(ary, indices_or_sections, 0, True)


def dsplit(ary, indices_or_sections):
    a = _proc(ary)
    if a.ndim < 3:
        raise ValueError("dsplit only works on arrays of 3 or more "
                         "dimensions")
    return _split_impl(a, indices_or_sections, 2, even_required=True)


def expand_dims(a, axis):
    return _np_invoke("expand_dims", [_proc(a)], {"axis": axis})


def squeeze(a, axis=None):
    return _np_invoke("squeeze", [_proc(a)], {"axis": axis})


def broadcast_to(array, shape):  # noqa: A002
    return _np_invoke("_npi_broadcast_to", [_proc(array)],
                      {"shape": (shape,) if isinstance(shape, int)
                       else tuple(shape)})


def broadcast_arrays(*args):
    arrs = _procs(*args)
    target = onp.broadcast_shapes(*[tuple(a.shape) for a in arrs])
    return [broadcast_to(a, target) for a in arrs]


def tile(a, reps):
    return _np_invoke("tile", [_proc(a)], {"reps": reps})


def repeat(a, repeats, axis=None):
    return _np_invoke("repeat", [_proc(a)], {"repeats": repeats,
                                             "axis": axis})


def flip(m, axis=None):
    a = _proc(m)
    if axis is None:
        axis = tuple(range(a.ndim))
    return _np_invoke("flip", [a], {"axis": axis})


def fliplr(m):
    return flip(m, 1)


def flipud(m):
    return flip(m, 0)


def roll(a, shift, axis=None):
    return _np_invoke("_npi_roll", [_proc(a)], {"shift": shift, "axis": axis})


def rot90(m, k=1, axes=(0, 1)):
    return _np_invoke("_npi_rot90", [_proc(m)], {"k": k, "axes": tuple(axes)})


def pad(array, pad_width, mode="constant", constant_values=0):  # noqa: A002
    return _np_invoke("_npi_pad", [_proc(array)],
                      {"pad_width": pad_width, "mode": mode,
                       "constant_values": constant_values})


def append(arr, values, axis=None):
    return _np_invoke("_npi_append", _procs(arr, values), {"axis": axis})


def where(condition, x=None, y=None):
    if x is None and y is None:
        return nonzero(condition)
    return _np_invoke("_npi_where", _procs(condition, x, y))


def take(a, indices, axis=None, mode="clip", out=None):
    a, indices = _procs(a, indices)
    if axis is None:
        a, axis = _np_arg(a).reshape(-1), 0
    return _np_invoke("take", [a, indices], {"axis": axis, "mode": mode},
                      out=out)


def take_along_axis(arr, indices, axis):
    return _np_invoke("_npi_take_along_axis", _procs(arr, indices),
                      {"axis": axis})


def clip(a, a_min=None, a_max=None, out=None):
    if a_min is None and a_max is None:
        raise ValueError("One of a_min and a_max must be given")
    a = _proc(a)
    if a_min is None:
        return _np_invoke("broadcast_minimum", _procs(a, a_max), out=out)
    if a_max is None:
        return _np_invoke("broadcast_maximum", _procs(a, a_min), out=out)
    return _np_invoke("clip", [a], {"a_min": a_min, "a_max": a_max}, out=out)


def nonzero(a):
    mat = _np_invoke("_npi_nonzero", [_proc(a)])
    return tuple(_np_invoke("_slice_get", [mat], {"key": i})
                 for i in range(mat.shape[0]))


def flatnonzero(a):
    return _np_invoke("_npi_flatnonzero", [_proc(a)])


def unique(ar, return_index=False, return_inverse=False, return_counts=False):
    r = _np_invoke("_npi_unique", [_proc(ar)],
                   {"return_index": return_index,
                    "return_inverse": return_inverse,
                    "return_counts": return_counts})
    return tuple(r) if isinstance(r, list) else r


def sort(a, axis=-1):
    return _np_invoke("sort", [_proc(a)], {"axis": axis, "is_ascend": True})


def argsort(a, axis=-1):
    return _np_invoke("argsort", [_proc(a)], {"axis": axis,
                                              "is_ascend": True})


def argmax(a, axis=None, out=None):
    return _np_invoke("argmax", [_proc(a)], {"axis": axis}, out=out)


def argmin(a, axis=None, out=None):
    return _np_invoke("argmin", [_proc(a)], {"axis": axis}, out=out)


def searchsorted(a, v, side="left"):
    return _np_invoke("_npi_searchsorted", _procs(a, v), {"side": side})


def atleast_1d(*arys):
    res = []
    for a in arys:
        a = _np_arg(a)
        res.append(a.reshape(1) if a.ndim == 0 else a)
    return res[0] if len(res) == 1 else res


def atleast_2d(*arys):
    res = []
    for a in arys:
        a = _np_arg(a)
        if a.ndim == 0:
            a = a.reshape(1, 1)
        elif a.ndim == 1:
            a = expand_dims(a, 0)
        res.append(a)
    return res[0] if len(res) == 1 else res


def atleast_3d(*arys):
    res = []
    for a in arys:
        a = _np_arg(a)
        if a.ndim == 0:
            a = a.reshape(1, 1, 1)
        elif a.ndim == 1:
            a = a.reshape(1, -1, 1)
        elif a.ndim == 2:
            a = expand_dims(a, 2)
        res.append(a)
    return res[0] if len(res) == 1 else res


def insert_dims_like(a, like):
    """Not in NumPy: ``a`` with trailing 1s until it has ``like``'s
    rank, for broadcasting."""
    a = _proc(a)
    while a.ndim < _proc(like).ndim:
        a = expand_dims(a, -1)
    return a


# ---------------------------------------------------------------------------
# elementwise math
# ---------------------------------------------------------------------------
def _make_binary(fname, opname):
    def f(x1, x2, out=None):
        return _np_invoke(opname, _procs(x1, x2), None, out=out)
    f.__name__ = fname
    f.__doc__ = f"numpy.{fname}; dispatches the registry op {opname}."
    return f


_BINARY_TABLE = {
    "add": "broadcast_add", "subtract": "broadcast_sub",
    "multiply": "broadcast_mul", "divide": "broadcast_div",
    "true_divide": "broadcast_div", "mod": "broadcast_mod",
    "remainder": "broadcast_mod", "fmod": "_npi_fmod",
    "power": "broadcast_power", "maximum": "broadcast_maximum",
    "minimum": "broadcast_minimum", "fmax": "_npi_fmax",
    "fmin": "_npi_fmin", "hypot": "broadcast_hypot", "arctan2": "arctan2",
    "logaddexp": "_npi_logaddexp", "logaddexp2": "_npi_logaddexp2",
    "copysign": "_npi_copysign", "ldexp": "_npi_ldexp",
    "heaviside": "_npi_heaviside", "gcd": "_npi_gcd", "lcm": "_npi_lcm",
    "bitwise_and": "_npi_bitwise_and", "bitwise_or": "_npi_bitwise_or",
    "bitwise_xor": "_npi_bitwise_xor", "left_shift": "_npi_left_shift",
    "right_shift": "_npi_right_shift",
    # comparisons and logicals give bool (the classic broadcast_* family
    # keeps the input's type)
    "logical_and": "_npi_logical_and", "logical_or": "_npi_logical_or",
    "logical_xor": "_npi_logical_xor",
    "equal": "_npi_equal", "not_equal": "_npi_not_equal",
    "greater": "_npi_greater", "greater_equal": "_npi_greater_equal",
    "less": "_npi_less", "less_equal": "_npi_less_equal",
    "floor_divide": "_npi_floor_divide",
}

for _f, _o in _BINARY_TABLE.items():
    globals()[_f] = _make_binary(_f, _o)


def _make_unary(fname, opname):
    def f(x, out=None):
        return _np_invoke(opname, [_proc(x)], None, out=out)
    f.__name__ = fname
    f.__doc__ = f"numpy.{fname}; dispatches the registry op {opname}."
    return f


_UNARY_TABLE = {
    "absolute": "abs", "abs": "abs", "fabs": "abs", "sign": "sign",
    "exp": "exp", "expm1": "expm1", "exp2": "_npi_exp2", "log": "log",
    "log2": "log2", "log10": "log10", "log1p": "log1p", "sqrt": "sqrt",
    "cbrt": "cbrt", "square": "square", "reciprocal": "reciprocal",
    "negative": "negative", "positive": "copy", "sin": "sin", "cos": "cos",
    "tan": "tan", "arcsin": "arcsin", "arccos": "arccos",
    "arctan": "arctan", "sinh": "sinh", "cosh": "cosh", "tanh": "tanh",
    "arcsinh": "arcsinh", "arccosh": "arccosh", "arctanh": "arctanh",
    "degrees": "degrees", "radians": "radians", "deg2rad": "radians",
    "rad2deg": "degrees", "rint": "rint", "floor": "floor", "ceil": "ceil",
    "trunc": "trunc", "fix": "fix", "isnan": "isnan", "isinf": "isinf",
    "isfinite": "isfinite", "logical_not": "_npi_logical_not",
    "invert": "_npi_invert", "bitwise_not": "_npi_invert",
    "signbit": "_npi_signbit",
}

for _f, _o in _UNARY_TABLE.items():
    globals()[_f] = _make_unary(_f, _o)

__all__ += [f for f in (*_UNARY_TABLE, *_BINARY_TABLE) if f not in __all__]


def nan_to_num(x, nan=0.0, posinf=None, neginf=None):
    return _np_invoke("_npi_nan_to_num", [_proc(x)],
                      {"nan": nan, "posinf": posinf, "neginf": neginf})


# ---------------------------------------------------------------------------
# reductions
# ---------------------------------------------------------------------------
def _reduce(name, a, axis, keepdims, out=None, dtype=None):
    r = _np_invoke(name, [_proc(a)], {"axis": axis, "keepdims": keepdims},
                   out=out)
    return r.astype(dtype) if dtype is not None else r


def sum(a, axis=None, dtype=None, keepdims=False, out=None):  # noqa: A001
    return _reduce("sum", a, axis, keepdims, out, dtype)


def prod(a, axis=None, keepdims=False, out=None):
    return _reduce("prod", a, axis, keepdims, out)


def mean(a, axis=None, dtype=None, keepdims=False, out=None):
    return _reduce("mean", a, axis, keepdims, out, dtype)


def std(a, axis=None, ddof=0, keepdims=False):
    return _np_invoke("_npi_std", [_proc(a)],
                      {"axis": axis, "ddof": ddof, "keepdims": keepdims})


def var(a, axis=None, ddof=0, keepdims=False):
    return _np_invoke("_npi_var", [_proc(a)],
                      {"axis": axis, "ddof": ddof, "keepdims": keepdims})


def median(a, axis=None, keepdims=False):
    return _reduce("_npi_median", a, axis, keepdims)


def quantile(a, q, axis=None, keepdims=False, interpolation="linear"):
    return _np_invoke("_npi_quantile", _procs(a, q),
                      {"axis": axis, "keepdims": keepdims,
                       "interpolation": interpolation})


def percentile(a, q, axis=None, keepdims=False, interpolation="linear"):
    return _np_invoke("_npi_percentile", _procs(a, q),
                      {"axis": axis, "keepdims": keepdims,
                       "interpolation": interpolation})


def average(a, axis=None, weights=None):
    return _np_invoke("_npi_average", _procs(a, weights), {"axis": axis})


def max(a, axis=None, keepdims=False, out=None):  # noqa: A001
    return _reduce("max", a, axis, keepdims, out)


def min(a, axis=None, keepdims=False, out=None):  # noqa: A001
    return _reduce("min", a, axis, keepdims, out)


amax = max
amin = min


def nanmax(a, axis=None, keepdims=False):
    return _reduce("_npi_nanmax", a, axis, keepdims)


def nanmin(a, axis=None, keepdims=False):
    return _reduce("_npi_nanmin", a, axis, keepdims)


def nanmean(a, axis=None, keepdims=False):
    return _reduce("_npi_nanmean", a, axis, keepdims)


def nansum(a, axis=None, keepdims=False):
    return _reduce("nansum", a, axis, keepdims)


def nanprod(a, axis=None, keepdims=False):
    return _reduce("nanprod", a, axis, keepdims)


def cumsum(a, axis=None, dtype=None):
    r = _np_invoke("cumsum", [_proc(a)], {"axis": axis})
    return r.astype(dtype) if dtype is not None else r


def cumprod(a, axis=None, dtype=None):
    return _np_invoke("_npi_cumprod", [_proc(a)],
                      {"axis": axis, "dtype": dtype})


def all(a, axis=None, keepdims=False):  # noqa: A001
    return _reduce("_npi_all", a, axis, keepdims)


def any(a, axis=None, keepdims=False):  # noqa: A001
    return _reduce("_npi_any", a, axis, keepdims)


def count_nonzero(a, axis=None, keepdims=False):
    return _reduce("_npi_count_nonzero", a, axis, keepdims)


def ptp(a, axis=None, keepdims=False):
    return _reduce("_npi_ptp", a, axis, keepdims)


def diff(a, n=1, axis=-1):
    return _np_invoke("_npi_diff", [_proc(a)], {"n": n, "axis": axis})


def ediff1d(ary):
    return _np_invoke("_npi_ediff1d", [_proc(ary)])


def bincount(x, weights=None, minlength=0):
    return _np_invoke("_npi_bincount", _procs(x, weights),
                      {"minlength": minlength})


def histogram(a, bins=10, range=None):  # noqa: A002
    r = _np_invoke("_npi_histogram", [_proc(a)],
                   {"bins": bins, "range": range})
    return r[0], r[1]


def around(a, decimals=0, out=None):
    if decimals == 0:
        return _np_invoke("round", [_proc(a)], None, out=out)
    f = 10.0 ** decimals
    r = _np_invoke("round", [multiply(_proc(a), f)]) / f
    return _copy_out(r, out)


round = around  # noqa: A001
round_ = around


# ---------------------------------------------------------------------------
# contractions
# ---------------------------------------------------------------------------
def dot(a, b, out=None):
    return _np_invoke("_npi_dot", _procs(a, b), None, out=out)


def vdot(a, b):
    return _np_invoke("_npi_vdot", _procs(a, b))


def inner(a, b):
    return _np_invoke("_npi_inner", _procs(a, b))


def outer(a, b):
    return _np_invoke("_npi_outer", _procs(a, b))


def matmul(a, b, out=None):
    return _np_invoke("_npi_matmul", _procs(a, b), None, out=out)


def tensordot(a, b, axes=2):
    return _np_invoke("_npi_tensordot", _procs(a, b), {"axes": axes})


def einsum(subscripts, *operands, optimize=True):
    return _np_invoke("_npi_einsum", _procs(*operands),
                      {"subscripts": subscripts, "optimize": optimize})


def kron(a, b):
    return _np_invoke("_npi_kron", _procs(a, b))


def cross(a, b, axis=-1):
    return _np_invoke("_npi_cross", _procs(a, b), {"axis": axis})


# ---------------------------------------------------------------------------
# logic and misc
# ---------------------------------------------------------------------------
def isclose(a, b, rtol=1e-05, atol=1e-08, equal_nan=False):
    return _np_invoke("_npi_isclose", _procs(a, b),
                      {"rtol": rtol, "atol": atol, "equal_nan": equal_nan})


def allclose(a, b, rtol=1e-05, atol=1e-08, equal_nan=False):
    return bool(isclose(a, b, rtol, atol, equal_nan).all().item())


def array_equal(a1, a2):
    a1, a2 = _procs(a1, a2)
    if tuple(a1.shape) != tuple(a2.shape):
        return False
    return bool(equal(a1, a2).all().item())  # noqa: F821


def interp(x, xp, fp, left=None, right=None):
    return _np_invoke("_npi_interp", _procs(x, xp, fp),
                      {"left": left, "right": right})


def shape(a):
    return tuple(_np_arg(a).shape)


def size(a):
    return int(_np_arg(a).numel())


def ndim(a):
    return _np_arg(a).ndim


def may_share_memory(a, b):
    """Whether the two arrays' storages are one."""
    a, b = _procs(a, b)
    return a.untyped_storage().data_ptr() == b.untyped_storage().data_ptr()


def _np_of(a):
    return np_dtype(_tdtype(a)) if isinstance(a, torch.Tensor) else a


def result_type(*args):
    return onp.result_type(*[_np_of(a) for a in args])


def promote_types(t1, t2):
    return onp.promote_types(t1, t2)


def finfo(dtype):
    return onp.finfo(onp.dtype(dtype))


def iinfo(dtype):
    return onp.iinfo(onp.dtype(dtype))


# ---------------------------------------------------------------------------
# index helpers, window functions and the remaining creation functions
# ---------------------------------------------------------------------------
def argwhere(a):
    return _np_invoke("_npi_argwhere", [_proc(a)])


def tri(N, M=None, k=0, dtype="float32", ctx=None):
    return _host(onp.tri(N, M, k, dtype=onp.dtype(dtype)), ctx, dtype)


def vander(x, N=None, increasing=False):
    a = asarray(x)
    if a.ndim != 1:
        raise ValueError("x must be a one-dimensional array or sequence")
    n = int(a.size) if N is None else int(N)
    # cumulative products, as NumPy's multiply.accumulate: integer powers
    # stay exact, and the registry ops keep it differentiable
    cols = [ones_like(a)]
    for _ in range(1, n):
        cols.append(multiply(cols[-1], a))  # noqa: F821
    if not increasing:
        cols = cols[::-1]
    return stack(cols, axis=1)


def hanning(M, ctx=None):
    return _host(onp.hanning(int(M)), ctx)


def hamming(M, ctx=None):
    return _host(onp.hamming(int(M)), ctx)


def blackman(M, ctx=None):
    return _host(onp.blackman(int(M)), ctx)


def indices(dimensions, dtype="int32", ctx=None):
    return _host(onp.indices(tuple(dimensions), dtype=onp.dtype(dtype)),
                 ctx, dtype)


def row_stack(arrays):
    return vstack(arrays)


def rollaxis(a, axis, start=0):
    x = _np_arg(a)
    n = x.ndim
    axis, start = int(axis) % n, int(start)
    if start < 0:
        start += n
    order = [d for d in range(n) if d != axis]
    order.insert(start if start <= axis else start - 1, axis)
    return x.transpose(order)


def _along(x, axis):
    """``x`` flattened (axis None) or with ``axis`` moved first."""
    if axis is None:
        return x.reshape(-1), None
    return moveaxis(x, int(axis), 0), int(axis)


def delete(arr, obj, axis=None):
    x, ax = _along(_np_arg(arr), axis)
    if isinstance(obj, torch.Tensor):
        obj = onp.asarray(obj.detach().cpu().numpy())
    keep = onp.delete(onp.arange(x.shape[0]), obj)
    out = _np_invoke("take", [x, array(keep, ctx=x.device)], {"axis": 0})
    return out if ax is None else moveaxis(out, 0, ax)


def insert(arr, obj, values, axis=None):
    """NumPy's ``insert``, as one gather from the array and the values
    (differentiable in both): NumPy's own ``insert`` places each
    value's code, so every placement rule is NumPy's."""
    x, ax = _along(_np_arg(arr), axis)
    if isinstance(obj, torch.Tensor):
        obj = onp.asarray(obj.detach().cpu().numpy())
    v = _np_arg(_proc(values, x)).astype(_tdtype(x))
    rest = tuple(x.shape[1:])
    if ax is None:
        codes = -1 - onp.arange(int(v.numel())).reshape(tuple(v.shape))
        rows = v.reshape(-1)
    else:
        if v.ndim < x.ndim:
            v = v.reshape((1,) * (x.ndim - v.ndim) + tuple(v.shape))
        rows = broadcast_to(v, (v.shape[0],) + rest)
        codes = -1 - onp.arange(rows.shape[0])
    marker = onp.insert(onp.arange(x.shape[0]), obj, codes)
    both = concatenate([x, rows], axis=0)
    pick = onp.where(marker >= 0, marker, x.shape[0] - 1 - marker)
    out = _np_invoke("take", [both, array(pick, ctx=x.device)], {"axis": 0})
    return out if ax is None else moveaxis(out, 0, ax)


def diag_indices_from(arr):
    x = _np_arg(arr)
    if x.ndim < 2:
        raise ValueError("input array must be at least 2-d")
    if len(set(x.shape)) != 1:
        raise ValueError("All dimensions of input must be of equal length")
    idx = arange(x.shape[0], ctx=x.device)
    return tuple(idx for _ in range(x.ndim))


def unravel_index(indices, shape):
    i = _np_arg(indices)
    out, rest = [], i.as_subclass(torch.Tensor)
    for s in reversed([int(s) for s in shape]):
        out.append(_new(rest % s))
        rest = rest // s
    return tuple(reversed(out))


def _copy_out(res, out):
    if out is None:
        return res
    out[...] = res
    return out


def isposinf(x, out=None):
    a = _proc(x)
    return _copy_out(logical_and(isinf(a), greater(a, 0.0)), out)  # noqa: F821


def isneginf(x, out=None):
    a = _proc(x)
    return _copy_out(logical_and(isinf(a), less(a, 0.0)), out)  # noqa: F821


def float_power(x1, x2):
    """NumPy's: both operands in float64 before the power (registry
    ops, so gradients flow)."""
    a, b = _procs(x1, x2)
    a = _np_arg(a).astype("float64") if isinstance(a, torch.Tensor) \
        else array(float(a), dtype="float64")
    b = _np_arg(b).astype("float64") if isinstance(b, torch.Tensor) \
        else float(b)
    return power(a, b)  # noqa: F821


def polyval(p, x):
    """Horner's scheme over registry ops: differentiable in ``p`` and
    ``x``."""
    c = _np_arg(p)
    v = _np_arg(x)
    if c.ndim != 1:
        raise ValueError("p must be a 1-D array of coefficients")
    if int(c.size) == 0:
        return zeros_like(v)
    out = zeros_like(v) + c[0]
    for i in range(1, int(c.size)):
        out = add(multiply(out, v), c[i])  # noqa: F821
    return out


def tril_indices(n, k=0, m=None, ctx=None):
    r, c = onp.tril_indices(n, k, m)
    return _host(r, ctx), _host(c, ctx)


def triu_indices(n, k=0, m=None, ctx=None):
    r, c = onp.triu_indices(n, k, m)
    return _host(r, ctx), _host(c, ctx)


__all__ += ["argwhere", "dsplit", "tri", "vander", "hanning", "hamming",
            "blackman", "indices", "tril_indices", "triu_indices",
            "row_stack", "rollaxis", "delete", "insert",
            "diag_indices_from", "unravel_index", "isposinf", "isneginf",
            "float_power", "polyval"]
