"""Tensor operators: elementwise, broadcast, reductions, shape and
index ops, products, ordering, linear algebra.

Port of ``mxnet_tpu/ndarray/op_impl_basic.py`` (MXNet's
``src/operator/tensor/`` family), table by table as that file lays
them out, plus the elementwise functions the JAX registry takes
straight from ``jax.numpy``, ``jax.nn`` and ``lax.special``. Each op is
a plain torch function with the JAX op's name, signature and meaning
(comparisons give the input's type, ``argmax``/``argsort``/``topk``
indices float32 unless asked, ``reshape`` takes MXNet's codes,
``repeat`` repeats elements, ``split`` takes a number of outputs).
Gradients are torch's autograd; the ops registered non-differentiable
run under ``no_grad``. Products (``dot``, ``batch_dot``,
``linalg_gemm*``) are ``torch.matmul``, cuBLAS on the card: the JAX
package computes them outside any Pallas kernel too, so no hand-written
kernel is owed here.
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from .ndarray import to_dtype
from .register import register_op

_F32 = torch.float32


def _dt(dtype):
    return to_dtype(dtype or "float32")


def _like(v, x):
    """A scalar as a 0-d tensor of ``x``'s type and device."""
    if isinstance(v, torch.Tensor):
        return v
    return torch.tensor(v, dtype=x.dtype if x.is_floating_point()
                        or isinstance(v, (bool, int)) else _F32,
                        device=x.device)


def _pair(a, b):
    """``(a, b)`` as tensors, a scalar side made like the other."""
    if not isinstance(a, torch.Tensor):
        a = _like(a, b)
    if not isinstance(b, torch.Tensor):
        b = _like(b, a)
    return a, b


# ----------------------------------------------------------------------
# elementwise unary (mshadow_op.h functors)
# ----------------------------------------------------------------------
def _cbrt(x):
    return torch.sign(x) * torch.abs(x).pow(1.0 / 3.0)


_UNARY = {
    "abs": torch.abs,
    "exp": torch.exp,
    "log": torch.log,
    "log2": torch.log2,
    "log10": torch.log10,
    "log1p": torch.log1p,
    "expm1": torch.expm1,
    "sqrt": torch.sqrt,
    "rsqrt": torch.rsqrt,
    "cbrt": _cbrt,
    "rcbrt": lambda x: 1.0 / _cbrt(x),
    "square": torch.square,
    "reciprocal": lambda x: 1.0 / x,
    "negative": torch.negative,
    "sin": torch.sin,
    "cos": torch.cos,
    "tan": torch.tan,
    "arcsin": torch.arcsin,
    "arccos": torch.arccos,
    "arctan": torch.arctan,
    "sinh": torch.sinh,
    "cosh": torch.cosh,
    "tanh": torch.tanh,
    "arcsinh": torch.arcsinh,
    "arccosh": torch.arccosh,
    "arctanh": torch.arctanh,
    "sigmoid": torch.sigmoid,
    "softsign": F.softsign,
    "relu": F.relu,
    "gamma": lambda x: torch.exp(torch.lgamma(x)),
    "gammaln": torch.lgamma,
    "erf": torch.erf,
    "erfinv": torch.erfinv,
    "degrees": torch.rad2deg,
    "radians": torch.deg2rad,
    "identity": lambda x: x + 0,
}

for _name, _fn in _UNARY.items():
    register_op(_name)(_fn)

register_op("copy", aliases=("_copy",))(lambda x: x + 0)
register_op("BlockGrad", aliases=("stop_gradient",), differentiable=False)(
    lambda x: x.detach())
register_op("make_loss")(lambda x: x + 0)

_NONDIFF_UNARY = {
    "round": torch.round,
    "rint": torch.round,
    "fix": torch.trunc,
    "floor": torch.floor,
    "ceil": torch.ceil,
    "trunc": torch.trunc,
    "sign": torch.sign,
    "logical_not": lambda x: torch.logical_not(x.bool()).to(x.dtype),
    "isnan": torch.isnan,
    "isinf": torch.isinf,
    "isfinite": torch.isfinite,
}
for _name, _fn in _NONDIFF_UNARY.items():
    register_op(_name, differentiable=False)(_fn)


@register_op("clip")
def clip(x, a_min=None, a_max=None):
    if a_min is None and a_max is None:
        return x + 0
    return torch.clamp(x, a_min, a_max)


@register_op("Cast", aliases=("cast",))
def cast(x, dtype="float32"):
    return x.to(_dt(dtype))


_CONSTANTS = {}


@register_op("_constant", differentiable=False)
def _constant(value=None, dtype="float32", device=None):
    """A small constant given as a parameter (the symbolic frontend's
    way to embed one). Each value, type and device is copied from the
    host once and kept; a call returns a device copy of it, so a CUDA
    graph's capture (which cannot hold a copy from the host) copies the
    tensor its warm-up made."""
    npv = np.asarray(value)
    dt = _dt(dtype)
    key = (npv.tobytes(), npv.shape, npv.dtype.str, dt, str(device))
    kept = _CONSTANTS.get(key)
    if kept is None:
        kept = _CONSTANTS[key] = torch.as_tensor(npv, dtype=dt,
                                                 device=device)
    return kept.clone()


@register_op("amp_cast")
def amp_cast(x, dtype="float32"):
    return x.to(_dt(dtype))


@register_op("amp_multicast")
def amp_multicast(*xs, num_outputs=None, cast_narrow=False):
    widths = [x.element_size() for x in xs]
    pick = int(np.argmin(widths) if cast_narrow else np.argmax(widths))
    return tuple(x.to(xs[pick].dtype) for x in xs)


# ----------------------------------------------------------------------
# broadcast binary (elemwise_binary_op_basic.cc + broadcast_op)
# ----------------------------------------------------------------------
def _maximum(a, b):
    return torch.maximum(*_pair(a, b))


def _minimum(a, b):
    return torch.minimum(*_pair(a, b))


_BINARY = {
    "broadcast_add": lambda a, b: a + b,
    "broadcast_sub": lambda a, b: a - b,
    "broadcast_mul": lambda a, b: a * b,
    "broadcast_div": lambda a, b: a / b,
    "broadcast_mod": lambda a, b: torch.remainder(*_pair(a, b)),
    "broadcast_power": lambda a, b: torch.pow(*_pair(a, b)),
    "broadcast_maximum": _maximum,
    "broadcast_minimum": _minimum,
    "broadcast_hypot": lambda a, b: torch.hypot(*_pair(a, b)),
    "arctan2": lambda a, b: torch.atan2(*_pair(a, b)),
}
_BIN_ALIASES = {
    "broadcast_add": ("elemwise_add", "_plus", "_add"),
    "broadcast_sub": ("elemwise_sub", "_minus", "_sub"),
    "broadcast_mul": ("elemwise_mul", "_mul"),
    "broadcast_div": ("elemwise_div", "_div"),
    "broadcast_power": ("_power",),
    "broadcast_mod": ("_mod",),
}
for _name, _fn in _BINARY.items():
    register_op(_name, aliases=_BIN_ALIASES.get(_name, ()))(_fn)

_CMP = {
    "broadcast_equal": torch.eq,
    "broadcast_not_equal": torch.ne,
    "broadcast_greater": torch.gt,
    "broadcast_greater_equal": torch.ge,
    "broadcast_lesser": torch.lt,
    "broadcast_lesser_equal": torch.le,
    "broadcast_logical_and": torch.logical_and,
    "broadcast_logical_or": torch.logical_or,
    "broadcast_logical_xor": torch.logical_xor,
}


def _cmp_wrap(fn):
    # MXNet comparisons give the input's type (1.0 / 0.0), not bool
    def impl(lhs, rhs):
        a, b = _pair(lhs, rhs)
        dt = lhs.dtype if isinstance(lhs, torch.Tensor) else _F32
        return fn(a, b).to(dt)
    return impl


for _name, _fn in _CMP.items():
    register_op(_name, differentiable=False)(_cmp_wrap(_fn))


def _scalar_op(fn):
    def impl(x, scalar=0.0, reverse=False):
        out = fn(scalar, x) if reverse else fn(x, scalar)
        if out.dtype != x.dtype and x.is_floating_point():
            out = out.to(x.dtype)
        return out
    return impl


def _smax(a, b):
    return torch.clamp(b, min=a) if not isinstance(a, torch.Tensor) \
        else torch.clamp(a, min=b)


def _smin(a, b):
    return torch.clamp(b, max=a) if not isinstance(a, torch.Tensor) \
        else torch.clamp(a, max=b)


_SCALAR = {
    "broadcast_add_scalar": (_BINARY["broadcast_add"], ("_plus_scalar",)),
    "broadcast_sub_scalar": (_BINARY["broadcast_sub"], ("_minus_scalar",)),
    "broadcast_mul_scalar": (_BINARY["broadcast_mul"], ("_mul_scalar",)),
    "broadcast_div_scalar": (_BINARY["broadcast_div"], ("_div_scalar",)),
    "broadcast_mod_scalar": (_BINARY["broadcast_mod"], ("_mod_scalar",)),
    "broadcast_power_scalar": (_BINARY["broadcast_power"],
                               ("_power_scalar",)),
    "broadcast_maximum_scalar": (_smax, ("_maximum_scalar",)),
    "broadcast_minimum_scalar": (_smin, ("_minimum_scalar",)),
}
for _name, (_fn, _al) in _SCALAR.items():
    register_op(_name, aliases=_al)(_scalar_op(_fn))


def _rev_scalar_op(fn):
    def impl(x, scalar=0.0, reverse=True):
        out = fn(scalar, x)
        if out.dtype != x.dtype and x.is_floating_point():
            out = out.to(x.dtype)
        return out
    return impl


register_op("_rminus_scalar")(_rev_scalar_op(_BINARY["broadcast_sub"]))
register_op("_rdiv_scalar")(_rev_scalar_op(_BINARY["broadcast_div"]))
register_op("_rpower_scalar")(_rev_scalar_op(_BINARY["broadcast_power"]))
register_op("_rmod_scalar")(_rev_scalar_op(_BINARY["broadcast_mod"]))

_SCALAR_CMP = {
    "broadcast_equal_scalar": torch.eq,
    "broadcast_not_equal_scalar": torch.ne,
    "broadcast_greater_scalar": torch.gt,
    "broadcast_greater_equal_scalar": torch.ge,
    "broadcast_lesser_scalar": torch.lt,
    "broadcast_lesser_equal_scalar": torch.le,
}


def _scalar_cmp(fn):
    def impl(x, scalar=0.0, reverse=False):
        a, b = _pair(scalar, x) if reverse else _pair(x, scalar)
        return fn(a, b).to(x.dtype)
    return impl


for _name, _fn in _SCALAR_CMP.items():
    register_op(_name, differentiable=False)(_scalar_cmp(_fn))


@register_op("add_n", aliases=("ElementWiseSum", "_sum"))
def add_n(*args):
    out = args[0]
    for a in args[1:]:
        out = out + a
    return out


@register_op("where")
def where(condition, x, y):
    return torch.where(condition.bool(), *_pair(x, y))


@register_op("maximum")
def maximum(lhs, rhs):
    return _maximum(lhs, rhs)


@register_op("minimum")
def minimum(lhs, rhs):
    return _minimum(lhs, rhs)


# ----------------------------------------------------------------------
# reductions (broadcast_reduce_op_value.cc)
# ----------------------------------------------------------------------
def _axes(axis, ndim, exclude=False):
    """``axis`` (None, int or sequence) as a sorted tuple of dims."""
    if axis is None:
        ax = tuple(range(ndim))
    elif isinstance(axis, (list, tuple)):
        ax = tuple(int(a) % max(ndim, 1) for a in axis)
    else:
        ax = (int(axis) % max(ndim, 1),)
    if exclude and axis is not None:
        ax = tuple(i for i in range(ndim) if i not in ax)
    return tuple(sorted(ax))


def _reduce(fn):
    def impl(x, axis=None, keepdims=False, exclude=False):
        ax = _axes(axis, x.ndim, exclude)
        out = x
        for a in reversed(ax):
            out = fn(out, a, keepdim=bool(keepdims))
        return out
    return impl


def _mean(x, dim, keepdim):
    # an integer array's mean is float32, as the JAX op's
    return torch.mean(x if x.is_floating_point() else x.float(), dim,
                      keepdim=keepdim)


def _nanprod(x, dim, keepdim):
    return torch.prod(torch.nan_to_num(x, nan=1.0), dim, keepdim=keepdim)


register_op("sum", aliases=("sum_axis",))(_reduce(torch.sum))
register_op("nansum")(_reduce(torch.nansum))
register_op("mean")(_reduce(_mean))
register_op("prod")(_reduce(torch.prod))
register_op("nanprod")(_reduce(_nanprod))
register_op("max", aliases=("max_axis",))(_reduce(torch.amax))
register_op("min", aliases=("min_axis",))(_reduce(torch.amin))


@register_op("norm")
def norm(x, ord=2, axis=None, keepdims=False):
    s = _reduce(torch.sum)
    if ord == 1:
        return s(torch.abs(x), axis, keepdims)
    return torch.sqrt(s(torch.square(x), axis, keepdims))


@register_op("L2Normalization")
def l2_normalization(x, eps=1e-10, mode="instance"):
    if mode == "instance":
        ax = tuple(range(1, x.ndim))
    elif mode == "channel":
        ax = (1,)
    else:                                               # spatial
        ax = tuple(range(2, x.ndim))
    n = torch.sqrt(torch.sum(torch.square(x), dim=ax, keepdim=True) + eps)
    return x / n


def _argreduce(fn):
    def impl(x, axis=None, keepdims=False):
        if axis is None:
            return fn(x.reshape(-1), 0).to(_F32)
        return fn(x, int(axis), keepdim=bool(keepdims)).to(_F32)
    return impl


register_op("argmax", differentiable=False)(_argreduce(torch.argmax))
register_op("argmin", differentiable=False)(_argreduce(torch.argmin))


@register_op("argmax_channel", differentiable=False)
def argmax_channel(x):
    return torch.argmax(x, 1).to(_F32)


# ----------------------------------------------------------------------
# shape ops (matrix_op.cc)
# ----------------------------------------------------------------------
def mx_shape(src, shape, reverse=False):
    """The shape MXNet's ``reshape`` codes give for ``src``: 0 keeps a
    dimension, -1 infers one, -2 copies the rest, -3 merges the next
    two, -4 splits one into the two values after it (either may be
    -1). ``reverse`` reads the codes right to left."""
    src = list(src)
    shape = list(shape)
    if reverse:
        src, shape = src[::-1], shape[::-1]
    out = []
    i = j = 0
    while j < len(shape):
        s = shape[j]
        if s == 0:
            out.append(src[i])
            i += 1
        elif s == -1:
            out.append(-1)
            i += 1
        elif s == -2:
            out.extend(src[i:])
            i = len(src)
        elif s == -3:
            out.append(src[i] * src[i + 1])
            i += 2
        elif s == -4:
            d1, d2 = shape[j + 1], shape[j + 2]
            if d1 == -1:
                d1 = src[i] // d2
            if d2 == -1:
                d2 = src[i] // d1
            out.extend([d1, d2])
            i += 1
            j += 2
        else:
            out.append(s)
            i += 1
        j += 1
    return tuple(out[::-1] if reverse else out)


@register_op("reshape", aliases=("Reshape",))
def reshape(x, shape=None, reverse=False):
    """``reshape`` with MXNet's codes (:func:`mx_shape`)."""
    shape = tuple(int(s) for s in shape)
    if not any(s in (0, -2, -3, -4) for s in shape):
        return torch.reshape(x, shape)
    return torch.reshape(x, mx_shape(x.shape, shape, bool(reverse)))


@register_op("reshape_like")
def reshape_like(x, other):
    return torch.reshape(x, other.shape)


@register_op("shape_array", differentiable=False)
def shape_array(x):
    return torch.tensor(tuple(x.shape), dtype=torch.int64, device=x.device)


@register_op("size_array", differentiable=False)
def size_array(x):
    return torch.tensor([x.numel()], dtype=torch.int64, device=x.device)


@register_op("transpose")
def transpose(x, axes=None):
    if axes is None or len(axes) == 0:
        axes = tuple(range(x.ndim - 1, -1, -1))
    return x.permute(*(int(a) for a in axes))


@register_op("swapaxes", aliases=("SwapAxis",))
def swapaxes(x, dim1=0, dim2=1):
    return torch.swapaxes(x, int(dim1), int(dim2))


@register_op("Flatten", aliases=("flatten",))
def flatten(x):
    return torch.reshape(x, (x.shape[0], -1))


@register_op("expand_dims")
def expand_dims(x, axis=0):
    return torch.unsqueeze(x, int(axis))


@register_op("squeeze")
def squeeze(x, axis=None):
    if axis is None:
        return torch.squeeze(x)
    return torch.squeeze(x, tuple(int(a) for a in np.atleast_1d(axis)))


@register_op("broadcast_to")
def broadcast_to(x, shape=None):
    shape = tuple(int(t) if t != 0 else s for t, s in zip(shape, x.shape))
    return torch.broadcast_to(x, shape)


@register_op("broadcast_like")
def broadcast_like(x, other):
    return torch.broadcast_to(x, other.shape)


@register_op("broadcast_axis", aliases=("broadcast_axes",))
def broadcast_axis(x, axis=(), size=()):
    target = list(x.shape)
    for a, s in zip(np.atleast_1d(axis), np.atleast_1d(size)):
        target[int(a)] = int(s)
    return torch.broadcast_to(x, tuple(target))


@register_op("tile")
def tile(x, reps=()):
    return torch.tile(x, tuple(int(r) for r in reps))


@register_op("repeat")
def repeat(x, repeats=1, axis=None):
    """Each element ``repeats`` times along ``axis`` (numpy's repeat;
    the flattened array when ``axis`` is None)."""
    return torch.repeat_interleave(x, int(repeats),
                                   dim=None if axis is None else int(axis))


@register_op("flip", aliases=("reverse",))
def flip(x, axis=0):
    return torch.flip(x, tuple(int(a) for a in np.atleast_1d(axis)))


_PAD_MODES = {"constant": "constant", "edge": "replicate",
              "reflect": "reflect"}


@register_op("pad", aliases=("Pad",))
def pad(x, mode="constant", pad_width=(), constant_value=0.0):
    """``pad_width`` is (before, after) per axis, every axis."""
    pw = [int(p) for p in pad_width]
    pairs = [(pw[2 * i], pw[2 * i + 1]) for i in range(len(pw) // 2)]
    flat = [e for lo_hi in reversed(pairs) for e in lo_hi]
    if mode == "constant":
        return F.pad(x, flat, mode="constant", value=constant_value)
    # replicate/reflect pad the trailing axes only: drop the leading
    # pairs, which MXNet requires to be zero there too
    lead = 0
    while lead < len(pairs) and pairs[lead] == (0, 0):
        lead += 1
    flat = [e for lo_hi in reversed(pairs[lead:]) for e in lo_hi]
    return F.pad(x, flat, mode=_PAD_MODES[mode])


@register_op("depth_to_space")
def depth_to_space(x, block_size=1):
    b = int(block_size)
    n, c, h, w = x.shape
    y = x.reshape(n, b, b, c // (b * b), h, w)
    y = y.permute(0, 3, 4, 1, 5, 2)
    return y.reshape(n, c // (b * b), h * b, w * b)


@register_op("space_to_depth")
def space_to_depth(x, block_size=1):
    b = int(block_size)
    n, c, h, w = x.shape
    y = x.reshape(n, c, h // b, b, w // b, b)
    y = y.permute(0, 3, 5, 1, 2, 4)
    return y.reshape(n, c * b * b, h // b, w // b)


# ----------------------------------------------------------------------
# slicing & indexing (matrix_op.cc / indexing_op.cc)
# ----------------------------------------------------------------------
def _index(x, idx):
    """``x[idx]`` for a tuple of slices, negative steps included (torch
    slicing takes only positive ones: those become index lists)."""
    out = x
    for ax in range(len(idx) - 1, -1, -1):
        s = idx[ax]
        if not isinstance(s, slice) or (s.step or 1) > 0:
            continue
        picks = list(range(*s.indices(x.shape[ax])))
        out = torch.index_select(out, ax, torch.tensor(
            picks, dtype=torch.int64, device=x.device))
        idx = idx[:ax] + (slice(None),) + idx[ax + 1:]
    return out[idx]


@register_op("_slice_get")
def _slice_get(x, key=None):
    return x[key]


@register_op("slice", aliases=("crop",))
def slice_op(x, begin=(), end=(), step=None):
    step = step or [None] * len(begin)
    return _index(x, tuple(slice(b, e, s)
                           for b, e, s in zip(begin, end, step)))


@register_op("slice_axis")
def slice_axis(x, axis=0, begin=0, end=None):
    axis = int(axis) % x.ndim
    idx = [slice(None)] * x.ndim
    idx[axis] = slice(begin, end)
    return x[tuple(idx)]


@register_op("slice_like")
def slice_like(x, shape_like, axes=()):
    axes = tuple(int(a) for a in np.atleast_1d(axes)) \
        if axes != () and axes is not None else tuple(range(x.ndim))
    idx = [slice(None)] * x.ndim
    for a in axes:
        idx[a] = slice(0, shape_like.shape[a])
    return x[tuple(idx)]


def segment_sum(values, ids, num_segments):
    """``out[i] = sum of values[j] where ids[j] == i`` for ``i <
    num_segments``, summed in a fixed order: a stable sort by id, then
    each id's rows added in their order (``torch.segment_reduce``), so
    no atomic adds and the same bits on every run, on the card and in a
    CUDA graph (no host read, no size that depends on the data). Half
    types are summed in float32. ``ids`` must lie in ``[0,
    num_segments)``."""
    ids = ids.reshape(-1).to(torch.int64)
    order = torch.sort(ids, stable=True).indices
    counts = torch.zeros(num_segments, dtype=torch.int64,
                         device=ids.device).scatter_add_(
        0, ids, torch.ones_like(ids))
    acc = values if values.dtype in (_F32, torch.float64) else \
        values.float()
    out = torch.segment_reduce(acc.index_select(0, order), "sum",
                               lengths=counts, axis=0, unsafe=True)
    return out.to(values.dtype)


class _TakeRows(torch.autograd.Function):
    """Rows of a table at in-range int64 ids; the table's gradient is
    :func:`segment_sum` of the output's (torch's own backward for a
    gather, an atomic ``index_add``, gives new bits on each call when
    ids repeat)."""

    @staticmethod
    def forward(ctx, table, ids):
        ctx.save_for_backward(ids)
        ctx.shape = table.shape
        flat = table.reshape(table.shape[0], -1)
        out = torch.index_select(flat, 0, ids.reshape(-1))
        return out.reshape(ids.shape + table.shape[1:])

    @staticmethod
    def backward(ctx, grad):
        (ids,) = ctx.saved_tensors
        rows = ctx.shape[0]
        g = grad.reshape(ids.numel(), -1)
        return segment_sum(g, ids, rows).reshape(ctx.shape), None


def take_rows(table, ids):
    """``table[ids]`` along the first axis for in-range int64 ``ids``,
    differentiable to ``table`` through :func:`segment_sum`."""
    return _TakeRows.apply(table, ids)


@register_op("take")
def take(x, indices, axis=0, mode="clip"):
    """Slices of ``x`` at ``indices`` along ``axis`` (not a flat take);
    out-of-range indices clip, or wrap with ``mode="wrap"``. Along the
    first axis the gradient to ``x`` sums in a fixed order
    (:func:`take_rows`)."""
    ax = int(axis) % x.ndim
    n = x.shape[ax]
    idx = indices.to(torch.int64)
    idx = idx.clamp(0, n - 1) if mode == "clip" else torch.remainder(idx, n)
    if ax == 0:
        return take_rows(x, idx)
    out = torch.index_select(x, ax, idx.reshape(-1))
    return out.reshape(x.shape[:ax] + idx.shape + x.shape[ax + 1:])


@register_op("batch_take")
def batch_take(x, indices):
    idx = indices.to(torch.int64).reshape(-1)
    return x[torch.arange(x.shape[0], device=x.device), idx]


@register_op("gather_nd")
def gather_nd(data, indices):
    return data[tuple(indices.to(torch.int64))]


@register_op("scatter_nd")
def scatter_nd(data, indices, shape=None):
    out = torch.zeros(tuple(shape), dtype=data.dtype, device=data.device)
    return out.index_put(tuple(indices.to(torch.int64)), data,
                         accumulate=True)


@register_op("one_hot", differentiable=False)
def one_hot(indices, depth=1, on_value=1.0, off_value=0.0, dtype="float32"):
    """Rows of ``depth``; an out-of-range index gives a row of
    ``off_value``."""
    hit = indices.to(torch.int64)[..., None] == torch.arange(
        int(depth), device=indices.device)
    oh = hit.to(_dt(dtype))
    return oh * (on_value - off_value) + off_value


def _lens_shape(data, ax, lens):
    batch_axis = 1 if ax == 0 else 0
    shape = [1] * data.ndim
    shape[batch_axis] = data.shape[batch_axis]
    return lens.reshape(shape)


@register_op("SequenceMask")
def sequence_mask(data, sequence_length=None, use_sequence_length=False,
                  value=0.0, axis=0):
    if not use_sequence_length or sequence_length is None:
        return data + 0
    ax = int(axis)
    shape = [1] * data.ndim
    shape[ax] = data.shape[ax]
    steps = torch.arange(data.shape[ax], device=data.device).reshape(shape)
    keep = steps < _lens_shape(data, ax, sequence_length)
    return torch.where(keep, data, torch.tensor(value, dtype=data.dtype,
                                                device=data.device))


@register_op("SequenceLast")
def sequence_last(data, sequence_length=None, use_sequence_length=False,
                  axis=0):
    ax = int(axis)
    if not use_sequence_length or sequence_length is None:
        return data.select(ax, -1)
    last = _lens_shape(data, ax, sequence_length.to(torch.int64) - 1)
    idx = last.expand(tuple(1 if i == ax else data.shape[i]
                            for i in range(data.ndim)))
    return torch.gather(data, ax, idx).squeeze(ax)


@register_op("SequenceReverse")
def sequence_reverse(data, sequence_length=None, use_sequence_length=False,
                     axis=0):
    if not use_sequence_length or sequence_length is None:
        return torch.flip(data, (int(axis),))
    t = data.shape[0]
    steps = torch.arange(t, device=data.device)[:, None]
    lens = sequence_length.to(torch.int64)[None, :]
    rev = torch.where(steps < lens, lens - 1 - steps, steps)
    rev = rev.reshape(rev.shape + (1,) * (data.ndim - 2)).expand(data.shape)
    return torch.gather(data, 0, rev)


# ----------------------------------------------------------------------
# concat / stack / split
# ----------------------------------------------------------------------
@register_op("concat", aliases=("Concat",))
def concat(*args, dim=1, num_args=None):
    return torch.cat(args, dim=int(dim))


@register_op("stack")
def stack(*args, axis=0, num_args=None):
    return torch.stack(args, dim=int(axis))


def _squeezed(parts, axis, squeeze_axis):
    if squeeze_axis:
        return tuple(p.squeeze(axis) for p in parts)
    return tuple(parts)


@register_op("split", aliases=("SliceChannel",), dynamic_arity=True)
def split(x, num_outputs=1, axis=1, squeeze_axis=False):
    """``num_outputs`` equal parts along ``axis``."""
    ax, n = int(axis), int(num_outputs)
    if x.shape[ax] % n:
        raise ValueError(f"split: axis {ax} of size {x.shape[ax]} does "
                         f"not divide into {n} parts")
    return _squeezed(torch.split(x, x.shape[ax] // n, dim=ax), ax,
                     squeeze_axis)


@register_op("split_v2")
def split_v2(x, indices_or_sections=1, axis=0, squeeze_axis=False):
    ax = int(axis)
    if isinstance(indices_or_sections, int):
        return split(x, indices_or_sections, ax, squeeze_axis)
    return _squeezed(torch.tensor_split(
        x, [int(i) for i in indices_or_sections], dim=ax), ax, squeeze_axis)


# ----------------------------------------------------------------------
# dot / batch_dot / matmul (dot-inl.h): torch.matmul, cuBLAS on the card
# ----------------------------------------------------------------------
@register_op("dot")
def dot(lhs, rhs, transpose_a=False, transpose_b=False, forward_stype=None):
    """MXNet's dot: the last axis of ``lhs`` against the first of
    ``rhs``; ``transpose_a`` moves ``lhs``'s first axis last,
    ``transpose_b`` ``rhs``'s last axis first."""
    a = torch.movedim(lhs, 0, -1) if transpose_a else lhs
    b = torch.movedim(rhs, -1, 0) if transpose_b else rhs
    if a.ndim == 1 and b.ndim == 1:
        return torch.dot(a, b)
    return torch.tensordot(a, b, dims=([a.ndim - 1], [0]))


@register_op("batch_dot")
def batch_dot(lhs, rhs, transpose_a=False, transpose_b=False,
              forward_stype=None):
    a = torch.swapaxes(lhs, -1, -2) if transpose_a else lhs
    b = torch.swapaxes(rhs, -1, -2) if transpose_b else rhs
    return torch.matmul(a, b)


@register_op("matmul", aliases=("linalg_gemm2_nn",))
def matmul(a, b):
    return torch.matmul(a, b)


@register_op("khatri_rao")
def khatri_rao(*args):
    out = args[0]
    for m in args[1:]:
        out = torch.einsum("i...,j...->ij...", out, m) \
            .reshape(-1, out.shape[-1])
    return out


# ----------------------------------------------------------------------
# ordering (ordering_op.cc)
# ----------------------------------------------------------------------
@register_op("sort")
def sort(x, axis=-1, is_ascend=True):
    if axis is None:
        x, axis = x.reshape(-1), 0
    return torch.sort(x, dim=int(axis), descending=not is_ascend,
                      stable=True).values


@register_op("argsort", differentiable=False)
def argsort(x, axis=-1, is_ascend=True, dtype="float32"):
    key = x if is_ascend else -x
    if axis is None:
        key, axis = key.reshape(-1), 0
    return torch.argsort(key, dim=int(axis), stable=True).to(_dt(dtype))


@register_op("topk", differentiable=False)
def topk(x, axis=-1, k=1, ret_typ="indices", is_ascend=False,
         dtype="float32"):
    ax = x.ndim - 1 if axis is None else int(axis) % x.ndim
    vals, idx = torch.topk(x, int(k), dim=ax, largest=not is_ascend,
                           sorted=True)
    if ret_typ == "indices":
        return idx.to(_dt(dtype))
    if ret_typ == "value":
        return vals
    if ret_typ == "mask":
        return torch.zeros_like(x).scatter(ax, idx, 1.0)
    return vals, idx.to(_dt(dtype))                     # 'both'


# ----------------------------------------------------------------------
# init-like ops
# ----------------------------------------------------------------------
@register_op("zeros_like")
def zeros_like(x):
    return torch.zeros_like(x)


@register_op("ones_like")
def ones_like(x):
    return torch.ones_like(x)


@register_op("_full_like")
def full_like(x, value=0.0):
    return torch.full_like(x, value)


@register_op("_arange_like", aliases=("arange_like",), differentiable=False)
def arange_like(x, start=0.0, step=1.0, repeat=1, axis=None):
    n = x.numel() if axis is None else x.shape[int(axis)]
    return (torch.arange(n, device=x.device, dtype=torch.float64) * step
            + start).to(x.dtype)


# ----------------------------------------------------------------------
# linalg (la_op.cc subset)
# ----------------------------------------------------------------------
def _t(a, flag):
    return torch.swapaxes(a, -1, -2) if flag else a


@register_op("linalg_gemm")
def linalg_gemm(A, B, C, transpose_a=False, transpose_b=False, alpha=1.0,
                beta=1.0, axis=-2):
    return alpha * torch.matmul(_t(A, transpose_a), _t(B, transpose_b)) \
        + beta * C


@register_op("linalg_gemm2")
def linalg_gemm2(A, B, transpose_a=False, transpose_b=False, alpha=1.0,
                 axis=-2):
    return alpha * torch.matmul(_t(A, transpose_a), _t(B, transpose_b))


@register_op("linalg_potrf")
def linalg_potrf(A):
    return torch.linalg.cholesky(A)


@register_op("linalg_trsm")
def linalg_trsm(A, B, transpose=False, rightside=False, lower=True,
                alpha=1.0):
    a = _t(A, transpose)
    low = (not lower) if transpose else lower
    return torch.linalg.solve_triangular(a, alpha * B, upper=not low,
                                         left=not rightside)


@register_op("linalg_sumlogdiag")
def linalg_sumlogdiag(A):
    return torch.sum(torch.log(torch.diagonal(A, dim1=-2, dim2=-1)), -1)


@register_op("linalg_extractdiag")
def linalg_extractdiag(A, offset=0):
    return torch.diagonal(A, offset=int(offset), dim1=-2, dim2=-1)


@register_op("linalg_syrk")
def linalg_syrk(A, transpose=False, alpha=1.0):
    a = _t(A, transpose)
    return alpha * torch.matmul(a, torch.swapaxes(a, -1, -2))


@register_op("linalg_potri")
def linalg_potri(A):
    """Inverse of ``A A^T`` from its Cholesky factor ``A``, by two
    triangular solves."""
    eye = torch.eye(A.shape[-1], dtype=A.dtype, device=A.device) \
        .expand(A.shape)
    ainv = torch.linalg.solve_triangular(A, eye, upper=False)
    return torch.matmul(torch.swapaxes(ainv, -1, -2), ainv)


@register_op("linalg_trmm")
def linalg_trmm(A, B, transpose=False, rightside=False, lower=True,
                alpha=1.0):
    tri = _t(torch.tril(A) if lower else torch.triu(A), transpose)
    out = torch.matmul(B, tri) if rightside else torch.matmul(tri, B)
    return alpha * out


@register_op("linalg_makediag")
def linalg_makediag(A, offset=0):
    return torch.diag_embed(A, offset=int(offset), dim1=-2, dim2=-1)


def _tri_count(n, offset, lower):
    k = offset if lower else -offset
    return int(np.clip(np.arange(n) + k + 1, 0, n).sum())


def _trian_n(m, offset, lower):
    for n in range(1, 65536):
        cnt = _tri_count(n, offset, lower)
        if cnt == m:
            return n
        if cnt > m:
            break
    raise ValueError(f"no matrix size has a {m}-entry triangle "
                     f"(offset={offset}, lower={lower})")


def _tri_indices(n, offset, lower, device):
    rows, cols = (np.tril_indices(n, k=offset) if lower
                  else np.triu_indices(n, k=offset))
    return (torch.as_tensor(rows, device=device),
            torch.as_tensor(cols, device=device))


@register_op("linalg_maketrian")
def linalg_maketrian(A, offset=0, lower=True):
    """Packed (..., m) -> (..., n, n) triangular, row-major packing."""
    offset, lower = int(offset), bool(lower)
    n = _trian_n(A.shape[-1], offset, lower)
    rows, cols = _tri_indices(n, offset, lower, A.device)
    flat = torch.zeros((math.prod(A.shape[:-1]), n * n), dtype=A.dtype,
                       device=A.device)
    pos = (rows * n + cols).expand(flat.shape[0], -1)
    flat = flat.scatter(1, pos, A.reshape(flat.shape[0], -1))
    return flat.reshape(A.shape[:-1] + (n, n))


@register_op("linalg_extracttrian")
def linalg_extracttrian(A, offset=0, lower=True):
    """(..., n, n) -> packed (..., m) triangle, row-major."""
    rows, cols = _tri_indices(A.shape[-1], int(offset), bool(lower),
                              A.device)
    return A[..., rows, cols]


# ----------------------------------------------------------------------
# im2col / col2im (src/operator/nn/im2col.h surface ops)
# ----------------------------------------------------------------------
def _conv_geom(kernel, stride, dilate, pad):
    k = tuple(int(v) for v in kernel)
    n = len(k)

    def as_t(v, d):
        return tuple(int(x) for x in v) if v else (d,) * n

    return k, as_t(stride, 1), as_t(dilate, 1), as_t(pad, 0)


@register_op("im2col")
def im2col(data, kernel=None, stride=None, dilate=None, pad=None):
    """(N, C, H, W) -> (N, C*kh*kw, out_h*out_w), channel-major then
    kernel position (the reference's buffer layout)."""
    (kh, kw), (sh, sw), (dh, dw), (ph, pw) = _conv_geom(
        kernel, stride, dilate, pad)
    x = F.pad(data, (pw, pw, ph, ph))
    n, c, hp, wp = x.shape
    oh = (hp - (dh * (kh - 1) + 1)) // sh + 1
    ow = (wp - (dw * (kw - 1) + 1)) // sw + 1
    cols = [x[:, :, i * dh:i * dh + (oh - 1) * sh + 1:sh,
              j * dw:j * dw + (ow - 1) * sw + 1:sw]
            for i in range(kh) for j in range(kw)]
    return torch.stack(cols, dim=2).reshape(n, c * kh * kw, oh * ow)


@register_op("col2im")
def col2im(data, output_size=None, kernel=None, stride=None, dilate=None,
           pad=None):
    """(N, C*kh*kw, L) -> (N, C, H, W): the windows added back (the
    adjoint of :func:`im2col`)."""
    (kh, kw), (sh, sw), (dh, dw), (ph, pw) = _conv_geom(
        kernel, stride, dilate, pad)
    h, w = (int(v) for v in output_size)
    n, ckk, _ = data.shape
    c = ckk // (kh * kw)
    hp, wp = h + 2 * ph, w + 2 * pw
    oh = (hp - (dh * (kh - 1) + 1)) // sh + 1
    ow = (wp - (dw * (kw - 1) + 1)) // sw + 1
    cols = data.reshape(n, c, kh * kw, oh, ow)
    out = torch.zeros((n, c, hp, wp), dtype=data.dtype, device=data.device)
    for i in range(kh):
        for j in range(kw):
            win = (slice(None), slice(None),
                   slice(i * dh, i * dh + (oh - 1) * sh + 1, sh),
                   slice(j * dw, j * dw + (ow - 1) * sw + 1, sw))
            out = out.index_put(_grid(win, out.shape, out.device),
                                cols[:, :, i * kw + j], accumulate=True)
    return out[:, :, ph:ph + h, pw:pw + w]


def _grid(win, shape, device):
    """Broadcast index tensors of a tuple of slices (index_put takes
    no slices)."""
    idx = [torch.arange(*s.indices(d), device=device)
           for s, d in zip(win, shape)]
    nd_ = len(idx)
    return tuple(t.reshape([-1 if k == a else 1 for k in range(nd_)])
                 for a, t in enumerate(idx))


# ----------------------------------------------------------------------
# misc
# ----------------------------------------------------------------------
@register_op("diag")
def diag(x, k=0, axis1=0, axis2=1):
    if x.ndim == 1:
        return torch.diag(x, int(k))
    return torch.diagonal(x, offset=int(k), dim1=int(axis1), dim2=int(axis2))


@register_op("smooth_l1")
def smooth_l1(x, scalar=1.0):
    s2 = scalar * scalar
    return torch.where(torch.abs(x) < 1.0 / s2, 0.5 * s2 * torch.square(x),
                       torch.abs(x) - 0.5 / s2)


@register_op("hard_sigmoid")
def hard_sigmoid(x, alpha=0.2, beta=0.5):
    return torch.clamp(alpha * x + beta, 0.0, 1.0)


@register_op("log_sigmoid")
def log_sigmoid(x):
    return F.logsigmoid(x)


@register_op("mish")
def mish(x):
    return x * torch.tanh(F.softplus(x))


@register_op("softplus")
def softplus(x):
    return F.softplus(x)


@register_op("cumsum")
def cumsum(x, axis=None, dtype=None):
    if dtype is not None:
        x = x.to(_dt(dtype))
    # the input's type, as the JAX op's (torch sums integers in int64)
    if axis is None:
        return torch.cumsum(x.reshape(-1), 0, dtype=x.dtype)
    return torch.cumsum(x, int(axis), dtype=x.dtype)


@register_op("digamma")
def digamma(x):
    return torch.digamma(x)


@register_op("unravel_index", aliases=["_unravel_index"])
def unravel_index(x, shape=()):
    """Flat indices -> coordinates stacked on a leading axis, in the
    input's type."""
    flat = x.to(torch.int64)
    coords = []
    for d in reversed([int(s) for s in shape]):
        coords.append(torch.remainder(flat, d))
        flat = torch.div(flat, d, rounding_mode="floor")
    return torch.stack(coords[::-1], 0).to(x.dtype)


@register_op("ravel_multi_index", aliases=["_ravel_multi_index"])
def ravel_multi_index(x, shape=()):
    """Coordinates (leading axis) -> flat indices, no range clipping,
    in the input's type."""
    dims = [int(s) for s in shape]
    stride = 1
    flat = torch.zeros(x.shape[1:], dtype=torch.int64, device=x.device)
    for i in range(len(dims) - 1, -1, -1):
        flat = flat + x[i].to(torch.int64) * stride
        stride *= dims[i]
    return flat.to(x.dtype)


__all__ = ["mx_shape"] + sorted(
    n for n, v in dict(globals()).items()
    if callable(v) and hasattr(v, "_op") and not n.startswith("_"))
