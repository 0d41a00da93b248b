"""Sparse arrays: ``row_sparse`` and ``csr``.

Port of ``mxnet_tpu/ndarray/sparse.py``: the types and constructors,
the conversions (``tostype_dense``, ``cast_storage``, ``zeros``,
``retain``), the sparse-aware ``dot``, ``csr_to_ell`` and the lazy
row updates of the optimizers (``sgd_update_rsp``,
``sgd_mom_update_rsp``, ``adam_update_rsp``, ``adagrad_update_rsp``).

**Representation.** A sparse array is a plain Python object that holds
dense tensors, not a ``torch.Tensor``: a tensor subclass whose
``shape`` is not its storage's breaks every torch op it meets. A
:class:`RowSparseNDArray` holds ``_data``, the present rows' values
(an :class:`~.ndarray.NDArray` of ``(rows,) + shape[1:]``), ``_aux``,
their row ids (int64, sorted and unique as the constructors make
them), and ``_shape``, the dense shape that ``shape`` reports. A
:class:`CSRNDArray` holds ``_data`` (the values), ``_aux`` (their
column ids) and ``_indptr``. So:

- ``isinstance(x, NDArray)`` is false for a sparse array, and
  ``isinstance(grad, RowSparseNDArray)`` is what routes an optimizer
  to its lazy row update; torch ops take ``x.todense()``;
- ``x.data`` is the values array itself, the same object on every
  read: ``w.data.attach_grad()`` makes it a leaf whose ``.grad`` a
  later push reads, as the reference's ``example/sparse_linear.py``
  does;
- ``KVStore.row_sparse_pull`` rewrites a destination's ``_data`` and
  ``_aux`` in place, and its row count changes.

The arrays live on their values' device and every op computes there.
The steps that read the host are the reference's own: ``cast_storage``
and ``retain`` size their results by the data (one read of a count),
``csr_to_ell`` lays out its padded rows in numpy, and a CSR built from
``(data, indices, indptr)`` takes numpy or tensors as given.

Sums over repeated ids (``dot`` with a transposed csr, the kvstore's
merge of pushed rows) go through ``op_impl_basic.segment_sum``: a
fixed order, no atomic adds, the same bits on every run. The lazy
updates touch only the rows present in the gradient, whose ids must be
unique (the kvstore merges a push before its updater runs); the other
rows keep their bits.
"""
from __future__ import annotations

import numpy as np
import torch

from ..base import MXNetError
from ..context import Context, resolve_device
from .ndarray import NDArray, as_nd, array as _dense_array, to_dtype
from .op_impl_basic import dot as _dense_dot
from .op_impl_basic import segment_sum

__all__ = ["BaseSparseNDArray", "CSRNDArray", "RowSparseNDArray",
           "adagrad_update_rsp", "adam_update_rsp", "cast_storage",
           "csr_matrix", "csr_to_ell", "dot", "retain", "row_sparse_array",
           "sgd_mom_update_rsp", "sgd_update_rsp", "tostype_dense", "zeros"]


def _plain(t):
    return t.as_subclass(torch.Tensor) if isinstance(t, NDArray) else t


def _nd(t):
    return t if isinstance(t, NDArray) else as_nd(t)


def _tensor(src, device, dtype=None):
    """A plain tensor of ``src`` (numpy, list or tensor) on ``device``;
    numpy keeps its type (float64 too, as the JAX constructors do)."""
    if isinstance(src, torch.Tensor):
        t = _plain(src).detach()
    else:
        t = torch.from_numpy(np.array(np.asarray(src), order="C"))
    return t.to(device=device, dtype=dtype or t.dtype)


class BaseSparseNDArray:
    """Common base of the sparse storage types (module docstring)."""

    stype = None

    def __init__(self, data, aux, shape):
        self._data = _nd(data)
        self._aux = _plain(aux)
        self._shape = tuple(int(s) for s in shape)

    @property
    def shape(self):
        return self._shape

    @shape.setter
    def shape(self, v):
        self._shape = tuple(int(s) for s in v)

    @property
    def ndim(self):
        return len(self._shape)

    @property
    def dtype(self):
        return self._data.dtype

    @property
    def device(self):
        return self._data.device

    @property
    def context(self):
        return Context.of(self._data.device)

    ctx = context

    @property
    def data(self):
        """The stored values (the same NDArray on every read)."""
        return self._data

    @property
    def indices(self):
        return _nd(self._aux)

    def asnumpy(self):
        return self.todense().asnumpy()

    def todense(self):
        return tostype_dense(self)

    def tostype(self, stype):
        if stype == self.stype:
            return self
        return cast_storage(self, stype)

    def wait_to_read(self):
        self._data.wait_to_read()

    def as_in_context(self, ctx):
        dev = resolve_device(ctx)
        return self if self.device == dev else self._moved(dev, None)

    def astype(self, dtype, copy=True):
        dt = to_dtype(dtype)
        if not copy and dt == self.dtype:
            return self
        return self._moved(self.device, dt)

    def copy(self):
        return self._moved(self.device, None)

    def copyto(self, other):
        """A copy on a ``Context``; into a sparse array of this type
        (its values and ids replaced); or, densified, into an NDArray."""
        if isinstance(other, Context):
            return self._moved(resolve_device(other), None)
        if isinstance(other, type(self)):
            src = self._moved(other.device, other.dtype)
            other.__dict__.update(src.__dict__)
            return other
        if isinstance(other, torch.Tensor):
            with torch.no_grad():
                other.copy_(self.todense())
            return other
        raise MXNetError(f"cannot copyto {type(other)}")

    def __repr__(self):
        return (f"\n<{type(self).__name__} "
                f"{'x'.join(map(str, self.shape))} @{self.context}>")


class RowSparseNDArray(BaseSparseNDArray):
    """row_sparse: the rows ``indices`` of a dense ``shape``, whose
    values are ``data`` (``(len(indices),) + shape[1:]``)."""

    stype = "row_sparse"

    def _moved(self, device, dtype):
        with torch.no_grad():
            data = _plain(self._data).to(device=device,
                                         dtype=dtype or self.dtype,
                                         copy=True)
        return RowSparseNDArray(data, self._aux.to(device, copy=True),
                                self._shape)

    def __repr__(self):
        return (f"\n<RowSparseNDArray {'x'.join(map(str, self.shape))} "
                f"({self._aux.shape[0]} rows) @{self.context}>")


class CSRNDArray(BaseSparseNDArray):
    """csr: a 2-D compressed sparse row matrix."""

    stype = "csr"

    def __init__(self, data, indices, indptr, shape):
        super().__init__(data, indices, shape)
        self._indptr = _plain(indptr)

    @property
    def indptr(self):
        return _nd(self._indptr)

    def _moved(self, device, dtype):
        with torch.no_grad():
            data = _plain(self._data).to(device=device,
                                         dtype=dtype or self.dtype,
                                         copy=True)
        return CSRNDArray(data, self._aux.to(device, copy=True),
                          self._indptr.to(device, copy=True), self._shape)

    def _rows(self):
        """The row of each stored value (on the device, no host read)."""
        m = self._shape[0]
        counts = self._indptr[1:] - self._indptr[:-1]
        return torch.repeat_interleave(
            torch.arange(m, device=self._indptr.device), counts,
            output_size=self._aux.shape[0])


def row_sparse_array(arg1, shape=None, ctx=None, dtype=None):
    """A RowSparseNDArray from ``(data, indices)`` (numpy, lists or
    tensors; ``shape`` defaults to ``max(indices) + 1`` rows) or from a
    dense source (``cast_storage``)."""
    if isinstance(arg1, tuple) and len(arg1) == 2:
        dev = resolve_device(ctx)
        data, indices = arg1
        data = _tensor(data, dev, to_dtype(dtype))
        indices = _tensor(indices, dev, torch.int64)
        if shape is None:
            shape = (int(indices.max()) + 1,) + tuple(data.shape[1:])
        return RowSparseNDArray(data, indices, shape)
    return cast_storage(_dense_array(arg1, ctx=ctx, dtype=dtype),
                        "row_sparse")


def csr_matrix(arg1, shape=None, ctx=None, dtype=None):
    """A CSRNDArray from ``(data, indices, indptr)`` and ``shape``, or
    from a dense source (``cast_storage``)."""
    if isinstance(arg1, tuple) and len(arg1) == 3:
        if shape is None:
            raise MXNetError("csr_matrix from (data, indices, indptr) "
                             "needs shape")
        dev = resolve_device(ctx)
        data, indices, indptr = arg1
        return CSRNDArray(_tensor(data, dev, to_dtype(dtype)),
                          _tensor(indices, dev, torch.int64),
                          _tensor(indptr, dev, torch.int64), shape)
    return cast_storage(_dense_array(arg1, ctx=ctx, dtype=dtype), "csr")


def tostype_dense(sp):
    """The dense NDArray of a sparse array (a dense one passes)."""
    if isinstance(sp, RowSparseNDArray):
        out = torch.zeros(sp.shape, dtype=sp.dtype, device=sp.device)
        return _nd(out.index_copy(0, sp._aux, _plain(sp._data)))
    if isinstance(sp, CSRNDArray):
        out = torch.zeros(sp.shape, dtype=sp.dtype, device=sp.device)
        return _nd(out.index_put((sp._rows(), sp._aux), _plain(sp._data)))
    return sp


def cast_storage(arr, stype):
    """``arr`` in storage ``stype`` ("default", "row_sparse", "csr");
    the reference's ``cast_storage``. The nonzero rows (or entries) are
    found on the array's device; their count is read on the host to
    size the result."""
    if stype == "default":
        return tostype_dense(arr)
    if stype not in ("row_sparse", "csr"):
        raise MXNetError(f"unknown stype {stype}")
    dense = _plain(tostype_dense(arr)).detach()
    if stype == "row_sparse":
        flat = dense.reshape(dense.shape[0], -1)
        nz = torch.nonzero((flat != 0).any(dim=1)).reshape(-1)
        return RowSparseNDArray(dense.index_select(0, nz), nz, dense.shape)
    if dense.ndim != 2:
        raise MXNetError("csr requires 2-D")
    rows, cols = torch.nonzero(dense, as_tuple=True)
    indptr = torch.searchsorted(
        rows, torch.arange(dense.shape[0] + 1, device=dense.device))
    return CSRNDArray(dense[rows, cols], cols, indptr, dense.shape)


def zeros(stype, shape, ctx=None, dtype=None):
    """An all-zero array of ``stype`` (no rows, no entries)."""
    dev, dt = resolve_device(ctx), to_dtype(dtype) or torch.float32
    shape = tuple(shape)
    if stype == "row_sparse":
        return RowSparseNDArray(
            torch.zeros((0,) + shape[1:], dtype=dt, device=dev),
            torch.zeros((0,), dtype=torch.int64, device=dev), shape)
    if stype == "csr":
        return CSRNDArray(torch.zeros((0,), dtype=dt, device=dev),
                          torch.zeros((0,), dtype=torch.int64, device=dev),
                          torch.zeros((shape[0] + 1,), dtype=torch.int64,
                                      device=dev), shape)
    from .ndarray import zeros as dense_zeros
    return dense_zeros(shape, ctx, dtype)


def retain(data, indices):
    """``sparse_retain``: the rows of a RowSparseNDArray whose ids are
    in ``indices`` (an array, list or NDArray)."""
    if not isinstance(data, RowSparseNDArray):
        raise MXNetError("retain expects row_sparse input")
    want = _tensor(indices, data.device, torch.int64)
    keep = torch.nonzero(torch.isin(data._aux, want)).reshape(-1)
    return RowSparseNDArray(_plain(data._data).index_select(0, keep),
                            data._aux.index_select(0, keep), data.shape)


def dot(lhs, rhs, transpose_a=False, transpose_b=False):
    """Sparse-aware dot (the reference's ``dot`` sparse branches).

    ``dot(csr, dense)`` and ``dot(csr.T, dense)`` never build the dense
    csr: the first gathers ``rhs``'s rows at the column ids, scales
    them by the values and sums them by row (the rows are in order, so
    ``segment_reduce`` over ``indptr``'s counts); the second gathers
    ``rhs``'s rows by the entries' rows and sums them into the column
    ids (``segment_sum``). Either is differentiable to ``rhs``. Other
    combinations densify and take the registry's ``dot``."""
    if isinstance(lhs, CSRNDArray) and not isinstance(
            rhs, BaseSparseNDArray) and not transpose_b and rhs.ndim == 2:
        r = _plain(rhs)
        vals = _plain(lhs._data)[:, None].to(r.dtype)
        if transpose_a:
            contrib = r.index_select(0, lhs._rows()) * vals
            out = segment_sum(contrib, lhs._aux, lhs.shape[1])
        else:
            contrib = r.index_select(0, lhs._aux) * vals
            counts = lhs._indptr[1:] - lhs._indptr[:-1]
            out = torch.segment_reduce(contrib, "sum", lengths=counts,
                                       axis=0, unsafe=True)
        return _nd(out)
    a = _plain(tostype_dense(lhs))
    b = _plain(tostype_dense(rhs))
    return _nd(_dense_dot(a, b, transpose_a=transpose_a,
                          transpose_b=transpose_b))


def csr_to_ell(csr, k=None):
    """A CSR batch as fixed-width padded gather form: ``(column ids
    (B, k) int32, values (B, k))``, zero-padded, on the csr's device.
    ``k`` defaults to the densest row; a row denser than ``k`` raises.
    Laid out in numpy (the reference's host step)."""
    indptr = _plain(csr._indptr).cpu().numpy()
    lens = np.diff(indptr)
    if k is None:
        k = int(lens.max()) if lens.size else 1
    if lens.size and int(lens.max()) > k:
        raise MXNetError(f"csr_to_ell: a row has {int(lens.max())} nnz > "
                         f"k={k}")
    b = csr.shape[0]
    rows = np.repeat(np.arange(b), lens)
    pos = np.arange(indptr[-1]) - np.repeat(indptr[:-1], lens)
    data = _plain(csr._data).detach()
    cols = np.zeros((b, k), np.int32)
    cols[rows, pos] = _plain(csr._aux).cpu().numpy()
    vals = torch.zeros((b, k), dtype=data.dtype, device=data.device)
    vals[torch.from_numpy(rows).to(data.device),
         torch.from_numpy(pos).to(data.device)] = data
    return _dense_array(cols, ctx=csr.context), _nd(vals)


# ----------------------------------------------------------------------
# lazy row updates (the reference's row_sparse FComputeEx branches of
# optimizer_op.cc): only the rows present in the gradient are read and
# written; each keeps the dense op's convention
# ----------------------------------------------------------------------
def _prep_sparse_grad(grad, rescale_grad, clip_gradient):
    g = _plain(grad._data) * rescale_grad
    if clip_gradient is not None and clip_gradient > 0:
        g = g.clamp(-clip_gradient, clip_gradient)
    return grad._aux, g


def _rows(t, idx):
    return _plain(t).index_select(0, idx)


def _put(t, idx, rows):
    _plain(t).index_copy_(0, idx, rows.to(t.dtype))


@torch.no_grad()
def sgd_update_rsp(weight, grad, lr=0.01, wd=0.0, rescale_grad=1.0,
                   clip_gradient=None):
    """``weight[rows] -= lr * (g + wd * weight[rows])``; other rows
    untouched."""
    idx, g = _prep_sparse_grad(grad, rescale_grad, clip_gradient)
    w = _rows(weight, idx)
    _put(weight, idx, w - lr * (g.to(w.dtype) + wd * w))
    return weight


@torch.no_grad()
def sgd_mom_update_rsp(weight, grad, mom, lr=0.01, momentum=0.0, wd=0.0,
                       rescale_grad=1.0, clip_gradient=None,
                       lazy_update=True):
    """Lazy momentum: only the touched rows decay their momentum, with
    the dense ``sgd_mom_update``'s lr-inside convention (``mom =
    momentum * mom - lr * (g + wd * w)``; ``w += mom``)."""
    idx, g = _prep_sparse_grad(grad, rescale_grad, clip_gradient)
    w, m = _rows(weight, idx), _rows(mom, idx)
    new_m = momentum * m - lr * (g.to(w.dtype) + wd * w)
    _put(mom, idx, new_m)
    _put(weight, idx, w + new_m)
    return weight


@torch.no_grad()
def adam_update_rsp(weight, grad, mean, var, lr=0.001, beta1=0.9,
                    beta2=0.999, epsilon=1e-8, wd=0.0, rescale_grad=1.0,
                    clip_gradient=None, lazy_update=True):
    """MXNet's Adam on the touched rows (``lr`` bias-corrected by the
    optimizer)."""
    idx, g = _prep_sparse_grad(grad, rescale_grad, clip_gradient)
    w = _rows(weight, idx)
    g = g.to(w.dtype) + wd * w
    new_m = beta1 * _rows(mean, idx) + (1.0 - beta1) * g
    new_v = beta2 * _rows(var, idx) + (1.0 - beta2) * g * g
    _put(mean, idx, new_m)
    _put(var, idx, new_v)
    _put(weight, idx, w - lr * new_m / (torch.sqrt(new_v) + epsilon))
    return weight


@torch.no_grad()
def adagrad_update_rsp(weight, grad, history, lr=0.01, epsilon=1e-7,
                       wd=0.0, rescale_grad=1.0, clip_gradient=None):
    """AdaGrad on the touched rows: ``h += g * g``; ``w -= lr * (g /
    sqrt(h + epsilon) + wd * w)``."""
    idx, g = _prep_sparse_grad(grad, rescale_grad, clip_gradient)
    w = _rows(weight, idx)
    g = g.to(w.dtype)
    new_h = _rows(history, idx) + g * g
    _put(history, idx, new_h)
    _put(weight, idx, w - lr * (g / torch.sqrt(new_h + epsilon) + wd * w))
    return weight
