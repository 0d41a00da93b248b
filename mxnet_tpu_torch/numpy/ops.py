"""The NumPy-semantics operators (the ``_npi_*`` family) on torch tensors.

Port of ``mxnet_tpu/numpy/ops.py`` (MXNet's
``src/operator/numpy/np_*.cc``): every ``mx.np`` function that no
classic op already computes dispatches one of these registered ops, so
the registry, autograd, AMP's cast hook and ``mx.sym.np`` see np-mode
work as they see classic work. Each op takes and returns plain tensors.

**Types** follow the JAX package's (whose x64 is on): an integer input
to a function that only gives fractions (``std``, ``median``,
``quantile``, ``average``, ``exp2``, ``logaddexp``, ...) gives float32;
integer ``cumprod``, ``diff``, ``ptp``, the products and ``nanmax`` keep
the input's type; ``trace``, ``count_nonzero``, ``nonzero``,
``argwhere`` and ``unique``'s indices give int64; ``searchsorted`` and
``matrix_rank`` int32; ``histogram``'s counts float32. The JAX package
gives float64 where an integer array meets a Python float (x64's
promotion); the port gives float32, MXNet's default float.

**Linear algebra** is ``torch.linalg`` (cuSOLVER/cuBLAS on the card);
``lstsq`` goes through the SVD, so every device gives NumPy's four
outputs. **Samplers** draw from the device's generator
(``mx.random``); the bits differ from ``jax.random``'s by design, the
distributions do not.
"""
from __future__ import annotations

import numpy as np
import torch

from .. import random as _random
from ..ndarray.ndarray import to_dtype
from ..ndarray.op_impl_random import _gamma
from ..ndarray.register import register_op

__all__ = []  # everything here is reached through the registry


def _dev(*xs):
    for x in xs:
        if isinstance(x, torch.Tensor):
            return x.device
    return torch.device("cpu")


def _t(x, like=None):
    """``x`` as a tensor (a Python scalar as a 0-d one, weak in torch's
    type promotion as in JAX's) on ``like``'s device."""
    if isinstance(x, torch.Tensor):
        return x
    return torch.as_tensor(x, device=_dev(like))


def _inexact(t):
    return t if t.is_floating_point() else t.to(torch.float32)


def _same(*xs):
    """The tensors (scalars made tensors) in their promoted type, the
    arrays with dimensions first and Python scalars and 0-d arrays
    weak, as in torch's (and JAX's) promotion."""
    like = next((x for x in xs if isinstance(x, torch.Tensor)), None)
    ts = [_t(x, like) for x in xs]
    order = sorted(range(len(xs)), key=lambda i: not (
        isinstance(xs[i], torch.Tensor) and xs[i].ndim > 0))
    dt = ts[order[0]].dtype
    for i in order[1:]:
        dt = torch.result_type(torch.empty((1,), dtype=dt), xs[i])
    return [t.to(dt) for t in ts]


def _axes(a, axis):
    if axis is None:
        return tuple(range(a.ndim))
    if isinstance(axis, (list, tuple)):
        return tuple(int(x) % max(a.ndim, 1) for x in axis)
    return (int(axis) % max(a.ndim, 1),)


def _last(a, axis):
    """``a`` with the reduced ``axis`` (None: all) moved last and
    flattened into one, and the kept shape with ones in their place."""
    ax = _axes(a, axis)
    keep = [d for d in range(a.ndim) if d not in ax]
    moved = a.permute(*keep, *ax) if a.ndim else a.reshape(1)
    flat = moved.reshape(*[a.shape[d] for d in keep], -1)
    kept_shape = [1 if d in ax else a.shape[d] for d in range(a.ndim)]
    return flat, kept_shape


def _reduce_last(a, axis, keepdims, fn):
    flat, kept = _last(a, axis)
    out = fn(flat)
    return out.reshape(kept) if keepdims else out


def _size(size):
    if size is None:
        return ()
    if isinstance(size, int):
        return (size,)
    return tuple(int(s) for s in size)


def _gen(device):
    return _random.generator(torch.device(device or "cpu"))


def _uniform(size, device, low=0.0, high=1.0):
    return torch.empty(_size(size), dtype=torch.float32,
                       device=device or "cpu").uniform_(
        low, high, generator=_gen(device))


# ---------------------------------------------------------------------------
# elementwise binaries NumPy adds over the classic broadcast_* family
# ---------------------------------------------------------------------------
@register_op("_npi_floor_divide")
def _npi_floor_divide(a, b):
    a, b = _same(a, b)
    return torch.div(a, b, rounding_mode="floor")


@register_op("_npi_logaddexp")
def _npi_logaddexp(a, b):
    a, b = _same(_inexact(_t(a, b)), _inexact(_t(b, a)))
    return torch.logaddexp(a, b)


@register_op("_npi_logaddexp2")
def _npi_logaddexp2(a, b):
    a, b = _same(_inexact(_t(a, b)), _inexact(_t(b, a)))
    return torch.logaddexp2(a, b)


@register_op("_npi_copysign")
def _npi_copysign(a, b):
    return torch.copysign(_inexact(_t(a, b)), _t(b, a))


@register_op("_npi_fmax")
def _npi_fmax(a, b):
    return torch.fmax(*_same(a, b))


@register_op("_npi_fmin")
def _npi_fmin(a, b):
    return torch.fmin(*_same(a, b))


@register_op("_npi_fmod")
def _npi_fmod(a, b):
    return torch.fmod(*_same(a, b))


@register_op("_npi_bitwise_and", differentiable=False)
def _npi_bitwise_and(a, b):
    return torch.bitwise_and(*_same(a, b))


@register_op("_npi_bitwise_or", differentiable=False)
def _npi_bitwise_or(a, b):
    return torch.bitwise_or(*_same(a, b))


@register_op("_npi_bitwise_xor", differentiable=False)
def _npi_bitwise_xor(a, b):
    return torch.bitwise_xor(*_same(a, b))


@register_op("_npi_invert", differentiable=False)
def _npi_invert(a):
    return torch.bitwise_not(a)


@register_op("_npi_left_shift", differentiable=False)
def _npi_left_shift(a, b):
    return torch.bitwise_left_shift(*_same(a, b))


@register_op("_npi_right_shift", differentiable=False)
def _npi_right_shift(a, b):
    return torch.bitwise_right_shift(*_same(a, b))


@register_op("_npi_gcd", differentiable=False)
def _npi_gcd(a, b):
    return torch.gcd(*_same(a, b))


@register_op("_npi_lcm", differentiable=False)
def _npi_lcm(a, b):
    return torch.lcm(*_same(a, b))


@register_op("_npi_exp2")
def _npi_exp2(a):
    return torch.exp2(_inexact(a))


@register_op("_npi_nan_to_num")
def _npi_nan_to_num(a, nan=0.0, posinf=None, neginf=None):
    if not a.is_floating_point():
        return a.clone()
    return torch.nan_to_num(a, nan=nan, posinf=posinf, neginf=neginf)


@register_op("_npi_isclose", differentiable=False)
def _npi_isclose(a, b, rtol=1e-05, atol=1e-08, equal_nan=False):
    a, b = _same(_inexact(_t(a, b)), _inexact(_t(b, a)))
    a, b = torch.broadcast_tensors(a, b)
    return torch.isclose(a, b, rtol=rtol, atol=atol, equal_nan=equal_nan)


@register_op("_npi_signbit", differentiable=False)
def _npi_signbit(a):
    return torch.signbit(a)


@register_op("_npi_heaviside")
def _npi_heaviside(a, b):
    a, b = _same(_inexact(_t(a, b)), _t(b, a))
    return torch.heaviside(*torch.broadcast_tensors(a, b))


@register_op("_npi_ldexp")
def _npi_ldexp(a, b):
    return torch.ldexp(_inexact(_t(a, b)), _t(b, a))


# ---------------------------------------------------------------------------
# reductions and statistics
# ---------------------------------------------------------------------------
def _dims(a, axis):
    return None if axis is None else list(_axes(a, axis))


@register_op("_npi_all", differentiable=False)
def _npi_all(a, axis=None, keepdims=False):
    return torch.all(a.bool(), dim=_axes(a, axis), keepdim=keepdims) \
        if a.ndim else a.bool().clone()


@register_op("_npi_any", differentiable=False)
def _npi_any(a, axis=None, keepdims=False):
    return torch.any(a.bool(), dim=_axes(a, axis), keepdim=keepdims) \
        if a.ndim else a.bool().clone()


@register_op("_npi_std")
def _npi_std(a, axis=None, ddof=0, keepdims=False):
    return torch.std(_inexact(a), dim=_dims(a, axis), correction=ddof,
                     keepdim=keepdims)


@register_op("_npi_var")
def _npi_var(a, axis=None, ddof=0, keepdims=False):
    return torch.var(_inexact(a), dim=_dims(a, axis), correction=ddof,
                     keepdim=keepdims)


def _quantile(a, q, axis, keepdims, interpolation):
    a = _inexact(a)
    q = q.to(a.dtype) if isinstance(q, torch.Tensor) else float(q)
    flat, kept = _last(a, axis)
    out = torch.quantile(flat, q, dim=-1, interpolation=interpolation)
    if keepdims:
        qshape = list(q.shape) if isinstance(q, torch.Tensor) else []
        out = out.reshape(qshape + kept)
    return out


@register_op("_npi_median")
def _npi_median(a, axis=None, keepdims=False):
    return _quantile(a, 0.5, axis, keepdims, "linear")


@register_op("_npi_quantile")
def _npi_quantile(a, q, axis=None, keepdims=False, interpolation="linear"):
    return _quantile(a, q, axis, keepdims, interpolation)


@register_op("_npi_percentile")
def _npi_percentile(a, q, axis=None, keepdims=False, interpolation="linear"):
    return _quantile(a, q / 100.0, axis, keepdims, interpolation)


@register_op("_npi_average")
def _npi_average(a, weights=None, axis=None):
    a = _inexact(a)
    if weights is None:
        return a.mean(dim=_dims(a, axis))
    w = weights.to(a.dtype)
    if w.ndim == 1 and a.ndim > 1:
        shape = [1] * a.ndim
        shape[int(axis) % a.ndim] = -1
        w = w.reshape(shape)
    w = w.expand_as(a)
    dims = _dims(a, axis)
    return (a * w).sum(dim=dims) / w.sum(dim=dims)


@register_op("_npi_cumprod")
def _npi_cumprod(a, axis=None, dtype=None):
    if axis is None:
        a, axis = a.reshape(-1), 0
    return torch.cumprod(a, dim=int(axis), dtype=to_dtype(dtype) or a.dtype)


@register_op("_npi_count_nonzero", differentiable=False)
def _npi_count_nonzero(a, axis=None, keepdims=False):
    return _reduce_last(a != 0, axis, keepdims,
                        lambda f: f.sum(dim=-1, dtype=torch.int64))


@register_op("_npi_diff")
def _npi_diff(a, n=1, axis=-1):
    return torch.diff(a, n=int(n), dim=int(axis))


@register_op("_npi_ptp")
def _npi_ptp(a, axis=None, keepdims=False):
    dims = _axes(a, axis)
    return torch.amax(a, dim=dims, keepdim=keepdims) - \
        torch.amin(a, dim=dims, keepdim=keepdims)


@register_op("_npi_bincount", differentiable=False)
def _npi_bincount(x, weights=None, minlength=0):
    out = torch.bincount(x.reshape(-1).long(), weights=weights,
                         minlength=int(minlength))
    return out if weights is None else out.to(weights.dtype)


@register_op("_npi_histogram", differentiable=False,
             num_visible_outputs=2)
def _npi_histogram(a, bins=10, range=None):  # noqa: A002
    a = _inexact(a).reshape(-1)
    if range is None:
        lo, hi = (float(a.min()), float(a.max())) if a.numel() else (0., 1.)
    else:
        lo, hi = float(range[0]), float(range[1])
    if lo == hi:
        lo, hi = lo - 0.5, hi + 0.5
    edges = torch.linspace(lo, hi, int(bins) + 1, dtype=a.dtype,
                           device=a.device)
    # NumPy's bins: [e_i, e_i+1), the last closed
    idx = torch.bucketize(a, edges, right=True) - 1
    idx = torch.where(a == edges[-1], idx.new_tensor(int(bins) - 1), idx)
    ok = (idx >= 0) & (idx < int(bins))
    counts = torch.zeros(int(bins), dtype=a.dtype, device=a.device)
    counts.index_add_(0, idx[ok], torch.ones_like(a[ok]))
    return counts, edges


def _nan_extreme(a, axis, keepdims, fn, fill):
    if not a.is_floating_point():
        return fn(a, dim=_axes(a, axis), keepdim=keepdims)
    nan = torch.isnan(a)
    out = fn(torch.where(nan, torch.full_like(a, fill), a),
             dim=_axes(a, axis), keepdim=keepdims)
    every = torch.all(nan, dim=_axes(a, axis), keepdim=keepdims)
    return torch.where(every, torch.full_like(out, float("nan")), out)


@register_op("_npi_nanmax")
def _npi_nanmax(a, axis=None, keepdims=False):
    return _nan_extreme(a, axis, keepdims, torch.amax, float("-inf"))


@register_op("_npi_nanmin")
def _npi_nanmin(a, axis=None, keepdims=False):
    return _nan_extreme(a, axis, keepdims, torch.amin, float("inf"))


@register_op("_npi_nanmean")
def _npi_nanmean(a, axis=None, keepdims=False):
    return torch.nanmean(_inexact(a), dim=_dims(a, axis), keepdim=keepdims)


# ---------------------------------------------------------------------------
# shapes and rearrangement
# ---------------------------------------------------------------------------
@register_op("_npi_roll")
def _npi_roll(a, shift=1, axis=None):
    if axis is None:
        return torch.roll(a.reshape(-1), shift).reshape(a.shape)
    return torch.roll(a, shift, axis)


@register_op("_npi_rot90")
def _npi_rot90(a, k=1, axes=(0, 1)):
    return torch.rot90(a, int(k), [int(x) for x in axes])


@register_op("_npi_moveaxis")
def _npi_moveaxis(a, source=0, destination=0):
    return torch.movedim(a, source, destination)


@register_op("_npi_tril")
def _npi_tril(a, k=0):
    return torch.tril(a, int(k))


@register_op("_npi_triu")
def _npi_triu(a, k=0):
    return torch.triu(a, int(k))


@register_op("_npi_trace")
def _npi_trace(a, offset=0, axis1=0, axis2=1):
    return torch.diagonal(a, int(offset), int(axis1), int(axis2)).sum(-1)


@register_op("_npi_diagonal")
def _npi_diagonal(a, offset=0, axis1=0, axis2=1):
    return torch.diagonal(a, int(offset), int(axis1), int(axis2)).clone()


@register_op("_npi_diagflat")
def _npi_diagflat(a, k=0):
    return torch.diagflat(a.reshape(-1), int(k))


@register_op("_npi_unique", differentiable=False)
def _npi_unique(a, return_index=False, return_inverse=False,
                return_counts=False):
    flat = a.reshape(-1)
    vals, inv, counts = torch.unique(flat, sorted=True, return_inverse=True,
                                     return_counts=True)
    outs = [vals]
    if return_index:
        first = torch.full(vals.shape, flat.numel(), dtype=torch.int64,
                           device=a.device)
        pos = torch.arange(flat.numel(), device=a.device)
        outs.append(first.scatter_reduce(0, inv, pos, "amin"))
    if return_inverse:
        outs.append(inv.reshape(-1))
    if return_counts:
        outs.append(counts)
    return tuple(outs) if len(outs) > 1 else vals


@register_op("_npi_nonzero", differentiable=False)
def _npi_nonzero(a):
    if a.ndim == 0:
        a = a.reshape(1)
    return torch.stack(torch.nonzero(a, as_tuple=True), dim=0)


@register_op("_npi_flatnonzero", differentiable=False)
def _npi_flatnonzero(a):
    return torch.nonzero(a.reshape(-1)).reshape(-1)


@register_op("_npi_searchsorted", differentiable=False)
def _npi_searchsorted(a, v, side="left"):
    a, v = _same(a, v)
    return torch.searchsorted(a, v, right=side == "right").to(torch.int32)


@register_op("_npi_take_along_axis")
def _npi_take_along_axis(a, indices, axis=-1):
    if axis is None:
        return torch.take_along_dim(a.reshape(-1), indices.reshape(-1).long())
    return torch.take_along_dim(a, indices.long(), dim=int(axis))


def _pad_widths(pad_width, ndim):
    pw = np.broadcast_to(np.asarray(pad_width, dtype=np.int64).reshape(
        (-1, 2) if np.ndim(pad_width) == 2 else
        ((1, -1) if np.ndim(pad_width) == 1 else (1, 1))), (ndim, 2))
    return [(int(b), int(e)) for b, e in pw]


@register_op("_npi_pad")
def _npi_pad(a, pad_width=0, mode="constant", constant_values=0):
    """NumPy's ``pad``: ``constant`` joins filled blocks to each axis;
    the other modes index the input with NumPy's own padded index
    arrays, so every mode NumPy has and gradients come for free."""
    widths = _pad_widths(pad_width, a.ndim)
    out = a
    for d, (b, e) in enumerate(widths):
        if not b and not e:
            continue
        if mode == "constant":
            cv = np.broadcast_to(np.asarray(constant_values),
                                 (a.ndim, 2))[d]
            parts = []
            for n, v in ((b, cv[0]), (0, None), (e, cv[1])):
                if v is None:
                    parts.append(out)
                elif n:
                    shape = list(out.shape)
                    shape[d] = n
                    parts.append(torch.full(shape, v.item(), dtype=out.dtype,
                                            device=out.device))
            out = torch.cat(parts, dim=d)
        else:
            idx = np.pad(np.arange(out.shape[d]), (b, e), mode=mode)
            out = out.index_select(d, torch.as_tensor(idx, device=a.device))
    return out if out is not a else a.clone()


@register_op("_npi_append")
def _npi_append(a, b, axis=None):
    a, b = _same(a, b)
    if axis is None:
        return torch.cat([a.reshape(-1), b.reshape(-1)])
    return torch.cat([a, b], dim=int(axis))


@register_op("_npi_interp")
def _npi_interp(x, xp, fp, left=None, right=None):
    x, xp, fp = (_inexact(_t(v, xp)) for v in (x, xp, fp))
    n = xp.shape[0]
    i = torch.searchsorted(xp, x.contiguous(), right=True).clamp(1, n - 1)
    x0, x1, y0, y1 = xp[i - 1], xp[i], fp[i - 1], fp[i]
    out = y0 + (x - x0) / (x1 - x0) * (y1 - y0)
    out = torch.where(x == x1, y1, out)
    lo = fp[0] if left is None else torch.as_tensor(left, dtype=fp.dtype)
    hi = fp[-1] if right is None else torch.as_tensor(right, dtype=fp.dtype)
    out = torch.where(x < xp[0], lo.to(out.device), out)
    return torch.where(x > xp[-1], hi.to(out.device), out)


@register_op("_npi_where")
def _npi_where(cond, x, y):
    x, y = _same(x, y)
    return torch.where(_t(cond, x).bool(), x, y)


@register_op("_npi_ediff1d")
def _npi_ediff1d(a):
    return torch.diff(a.reshape(-1))


@register_op("_npi_cross")
def _npi_cross(a, b, axis=-1):
    a, b = _same(a, b)
    a, b = torch.broadcast_tensors(a, b)
    return torch.linalg.cross(a, b, dim=int(axis))


@register_op("_npi_kron")
def _npi_kron(a, b):
    return torch.kron(*_same(a, b))


# ---------------------------------------------------------------------------
# products and contractions
# ---------------------------------------------------------------------------
@register_op("_npi_tensordot")
def _npi_tensordot(a, b, axes=2):
    a, b = _same(a, b)
    if isinstance(axes, (list, tuple)):
        axes = [[int(i) for i in (x if isinstance(x, (list, tuple)) else [x])]
                for x in axes]
    return torch.tensordot(a, b, dims=axes)


@register_op("_npi_einsum")
def _npi_einsum(*operands, subscripts="", optimize=True):
    return torch.einsum(subscripts, *_same(*operands))


@register_op("_npi_inner")
def _npi_inner(a, b):
    return torch.inner(*_same(a, b))


@register_op("_npi_outer")
def _npi_outer(a, b):
    a, b = _same(a, b)
    return torch.outer(a.reshape(-1), b.reshape(-1))


@register_op("_npi_vdot")
def _npi_vdot(a, b):
    a, b = _same(a, b)
    return (a.reshape(-1) * b.reshape(-1)).sum(dtype=a.dtype)


@register_op("_npi_matmul")
def _npi_matmul(a, b):
    return torch.matmul(*_same(a, b))


@register_op("_npi_dot")
def _npi_dot(a, b):
    """NumPy's ``dot``: a product with a 0-d operand, the inner product
    of vectors, the matrix product, and past 2-d the sum over ``a``'s
    last axis and ``b``'s second-to-last (not the classic ``dot``)."""
    a, b = _same(a, b)
    if a.ndim == 0 or b.ndim == 0:
        return a * b
    if b.ndim == 1 or (a.ndim <= 2 and b.ndim <= 2):
        return torch.matmul(a, b)
    return torch.tensordot(a, b, dims=([a.ndim - 1], [b.ndim - 2]))


# ---------------------------------------------------------------------------
# np.linalg (torch.linalg: cuSOLVER on the card)
# ---------------------------------------------------------------------------
@register_op("_npi_svd", num_visible_outputs=3)
def _npi_svd(a, full_matrices=False):
    return tuple(torch.linalg.svd(_inexact(a),
                                  full_matrices=bool(full_matrices)))


@register_op("_npi_inv")
def _npi_inv(a):
    return torch.linalg.inv(_inexact(a))


@register_op("_npi_pinv")
def _npi_pinv(a, rcond=1e-15):
    return torch.linalg.pinv(_inexact(a), rtol=rcond)


@register_op("_npi_det")
def _npi_det(a):
    return torch.linalg.det(_inexact(a))


@register_op("_npi_slogdet", num_visible_outputs=2)
def _npi_slogdet(a):
    return tuple(torch.linalg.slogdet(_inexact(a)))


@register_op("_npi_eigh", num_visible_outputs=2)
def _npi_eigh(a, UPLO="L"):
    return tuple(torch.linalg.eigh(_inexact(a), UPLO=UPLO))


@register_op("_npi_eigvalsh")
def _npi_eigvalsh(a, UPLO="L"):
    return torch.linalg.eigvalsh(_inexact(a), UPLO=UPLO)


@register_op("_npi_qr", num_visible_outputs=2)
def _npi_qr(a, mode="reduced"):
    return tuple(torch.linalg.qr(_inexact(a), mode=mode))


@register_op("_npi_cholesky")
def _npi_cholesky(a):
    return torch.linalg.cholesky(_inexact(a))


@register_op("_npi_solve")
def _npi_solve(a, b):
    a, b = _same(_inexact(a), b)
    if b.ndim == a.ndim - 1:
        return torch.linalg.solve(a, b.unsqueeze(-1)).squeeze(-1)
    return torch.linalg.solve(a, b)


@register_op("_npi_lstsq", differentiable=False, num_visible_outputs=4)
def _npi_lstsq(a, b, rcond=None):
    """NumPy's four outputs (solution, residuals, rank, singular
    values) from one SVD, on every device."""
    a, b = _same(_inexact(a), b)
    m, n = a.shape
    u, s, vh = torch.linalg.svd(a, full_matrices=False)
    cut = (np.finfo(np.float32).eps * max(m, n) if rcond is None
           else float(rcond)) * s[0]
    keep = s > cut
    rank = keep.sum().to(torch.int32)
    inv = torch.where(keep, 1.0 / s, torch.zeros_like(s))
    vec = b.ndim == 1
    bb = b.unsqueeze(-1) if vec else b
    x = vh.transpose(-2, -1) @ (inv.unsqueeze(-1) * (u.transpose(-2, -1)
                                                     @ bb))
    if int(rank) == n and m > n:
        resid = ((a @ x - bb) ** 2).sum(0)
    else:
        resid = torch.zeros((0,), dtype=a.dtype, device=a.device)
    return (x.squeeze(-1) if vec else x), resid, rank, s


@register_op("_npi_matrix_power")
def _npi_matrix_power(a, n=1):
    return torch.linalg.matrix_power(a, int(n))


@register_op("_npi_multi_dot")
def _npi_multi_dot(*arrays):
    return torch.linalg.multi_dot(list(_same(*arrays)))


@register_op("_npi_norm")
def _npi_norm(a, ord=None, axis=None, keepdims=False):  # noqa: A002
    if isinstance(axis, list):
        axis = tuple(axis)
    return torch.linalg.norm(_inexact(a), ord=ord, dim=axis,
                             keepdim=bool(keepdims))


@register_op("_npi_matrix_rank", differentiable=False)
def _npi_matrix_rank(a, tol=None):
    return torch.linalg.matrix_rank(_inexact(a), rtol=tol).to(torch.int32)


# ---------------------------------------------------------------------------
# np.random distributions beyond the classic random_* family
# ---------------------------------------------------------------------------
@register_op("_npi_random_beta", differentiable=False)
def _npi_random_beta(a=1.0, b=1.0, size=None, device=None):
    x = _gamma(a, _size(size), device, torch.float64)
    y = _gamma(b, _size(size), device, torch.float64)
    return (x / (x + y)).to(torch.float32)


@register_op("_npi_random_chisquare", differentiable=False)
def _npi_random_chisquare(df=1.0, size=None, device=None):
    return 2.0 * _gamma(float(df) / 2.0, _size(size), device)


@register_op("_npi_random_lognormal", differentiable=False)
def _npi_random_lognormal(mean=0.0, sigma=1.0, size=None, device=None):
    z = torch.empty(_size(size), device=device or "cpu").normal_(
        generator=_gen(device))
    return torch.exp(mean + sigma * z)


@register_op("_npi_random_laplace", differentiable=False)
def _npi_random_laplace(loc=0.0, scale=1.0, size=None, device=None):
    u = _uniform(size, device, -0.5, 0.5)
    return loc - scale * torch.sign(u) * torch.log1p(
        -2.0 * u.abs()).clamp_max(0.0)


@register_op("_npi_random_logistic", differentiable=False)
def _npi_random_logistic(loc=0.0, scale=1.0, size=None, device=None):
    u = _uniform(size, device).clamp(1e-7, 1 - 1e-7)
    return loc + scale * torch.log(u / (1.0 - u))


@register_op("_npi_random_gumbel", differentiable=False)
def _npi_random_gumbel(loc=0.0, scale=1.0, size=None, device=None):
    u = _uniform(size, device).clamp(1e-7, 1 - 1e-7)
    return loc - scale * torch.log(-torch.log(u))


@register_op("_npi_random_pareto", differentiable=False)
def _npi_random_pareto(a=1.0, size=None, device=None):
    u = _uniform(size, device).clamp_min(1e-7)
    return u ** (-1.0 / float(a)) - 1.0


@register_op("_npi_random_rayleigh", differentiable=False)
def _npi_random_rayleigh(scale=1.0, size=None, device=None):
    u = _uniform(size, device).clamp_min(1e-7)
    return scale * torch.sqrt(-2.0 * torch.log(u))


@register_op("_npi_random_weibull", differentiable=False)
def _npi_random_weibull(a=1.0, size=None, device=None):
    u = _uniform(size, device, 1e-7, 1.0)
    return (-torch.log(u)) ** (1.0 / float(a))


@register_op("_npi_random_power", differentiable=False)
def _npi_random_power(a=1.0, size=None, device=None):
    u = _uniform(size, device, 1e-7, 1.0)
    return u ** (1.0 / float(a))


@register_op("_npi_random_choice", differentiable=False)
def _npi_random_choice(a, p=None, size=None, replace=True):
    n, shape = a.shape[0], _size(size)
    k = int(np.prod(shape)) if shape else 1
    gen = _gen(a.device)
    if p is not None:
        idx = torch.multinomial(p.to(torch.float32), k,
                                replacement=bool(replace), generator=gen)
    elif replace:
        idx = torch.randint(0, n, (k,), generator=gen, device=a.device)
    else:
        idx = torch.randperm(n, generator=gen, device=a.device)[:k]
    return a[idx].reshape(shape + tuple(a.shape[1:]))


@register_op("_npi_random_permutation", differentiable=False)
def _npi_random_permutation(x):
    return x[torch.randperm(x.shape[0], generator=_gen(x.device),
                            device=x.device)]


# ---------------------------------------------------------------------------
# comparisons and logicals: bool results (the classic broadcast_*
# family keeps the input's type, MXNet's convention)
# ---------------------------------------------------------------------------
def _cmp(fn):
    def op(a, b):
        return fn(*_same(a, b))
    return op


for _name, _fn in {
        "_npi_equal": torch.eq, "_npi_not_equal": torch.ne,
        "_npi_greater": torch.gt, "_npi_greater_equal": torch.ge,
        "_npi_less": torch.lt, "_npi_less_equal": torch.le,
        "_npi_logical_and": torch.logical_and,
        "_npi_logical_or": torch.logical_or,
        "_npi_logical_xor": torch.logical_xor}.items():
    register_op(_name, differentiable=False)(_cmp(_fn))


@register_op("_npi_logical_not", differentiable=False)
def _npi_logical_not(a):
    return torch.logical_not(a)


@register_op("_npi_broadcast_to")
def _npi_broadcast_to(a, shape=()):
    # NumPy's broadcast_to prepends axes; the classic broadcast_to op
    # keeps MXNet's same-rank contract with 0 keeping a dimension
    return torch.broadcast_to(a, tuple(shape)).contiguous()


@register_op("_npi_argwhere", differentiable=False)
def _npi_argwhere(a):
    return torch.argwhere(a)


# ---------------------------------------------------------------------------
# statically shaped compositions as single ops, so ``mx.sym.np`` lowers
# them (multi-output ones with real output selectors)
# ---------------------------------------------------------------------------
@register_op("_npi_vstack")
def _npi_vstack(*arrays):
    return torch.vstack(_same(*arrays))


@register_op("_npi_hstack")
def _npi_hstack(*arrays):
    return torch.hstack(_same(*arrays))


@register_op("_npi_dstack")
def _npi_dstack(*arrays):
    return torch.dstack(_same(*arrays))


@register_op("_npi_column_stack")
def _npi_column_stack(*arrays):
    return torch.column_stack(_same(*arrays))


def _split_count(params):
    ios = params.get("indices_or_sections", 1)
    if isinstance(ios, str):
        import ast
        ios = ast.literal_eval(ios)
    if isinstance(ios, (list, tuple)):
        return len(ios) + 1
    return int(ios)


def _sections(x, ios, axis, even):
    if isinstance(ios, int):
        if even and x.shape[axis] % ios:
            raise ValueError("array split does not result in an equal "
                             "division")
        return tuple(t.clone() for t in torch.tensor_split(x, ios, dim=axis))
    return tuple(t.clone() for t in torch.tensor_split(x, list(ios),
                                                        dim=axis))


@register_op("_npi_split_np", infer_num_outputs=_split_count)
def _npi_split_np(x, indices_or_sections=1, axis=0):
    return _sections(x, indices_or_sections, int(axis), True)


@register_op("_npi_array_split", infer_num_outputs=_split_count)
def _npi_array_split(x, indices_or_sections=1, axis=0):
    return _sections(x, indices_or_sections, int(axis), False)


@register_op("_npi_meshgrid",
             infer_num_outputs=lambda p: int(p.get("num_outputs", 1)))
def _npi_meshgrid(*arrays, indexing="xy", num_outputs=None):
    return tuple(t.contiguous() for t in torch.meshgrid(
        *[a.reshape(-1) for a in arrays], indexing=indexing))


@register_op("_npi_broadcast_arrays",
             infer_num_outputs=lambda p: int(p.get("num_outputs", 1)))
def _npi_broadcast_arrays(*arrays, num_outputs=None):
    return tuple(t.contiguous() for t in torch.broadcast_tensors(*arrays))


@register_op("_npi_atleast_1d")
def _npi_atleast_1d(a):
    return torch.atleast_1d(a).clone()


@register_op("_npi_atleast_2d")
def _npi_atleast_2d(a):
    return torch.atleast_2d(a).clone()


@register_op("_npi_atleast_3d")
def _npi_atleast_3d(a):
    return torch.atleast_3d(a).clone()


@register_op("_npi_around")
def _npi_around(a, decimals=0):
    if not a.is_floating_point():
        return a.clone()
    return torch.round(a, decimals=int(decimals))
