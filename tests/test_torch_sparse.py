"""The port's ``ndarray.sparse`` and ``io`` iterators against the JAX
package's, on the CPU, with numpy-seeded inputs.

- Constructors, conversions, ``retain``, ``zeros``, ``csr_to_ell`` and
  the stype methods give the JAX package's arrays exactly (they move
  values, they compute nothing).
- ``dot(csr, dense)`` and ``dot(csr.T, dense)`` agree within 1e-6
  (float32 sums of a few products, summed in another order).
- The four lazy row updates agree within 1e-6 on the touched rows
  (the same float32 expressions; XLA may fuse them into other
  roundings), and the untouched rows keep their bits.
- ``LibSVMIter`` on the JAX tests' files (``tests/test_io.py``) gives
  the JAX iterator's batches exactly; ``NDArrayIter``, ``CSVIter``,
  ``ResizeIter``, ``PrefetchingIter`` and ``MNISTIter`` likewise.
"""
import gzip
import struct

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
from mxnet_tpu.ndarray import sparse as jsp
import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import nd
from mxnet_tpu_torch.ndarray import sparse as tsp

torch.set_num_threads(1)

TOL = 1e-6


def _dense(rs, shape, density=0.4):
    a = rs.randn(*shape).astype(np.float32)
    a[rs.rand(*shape) > density] = 0.0
    return a


def _rsp_dense(rs, shape, rows):
    a = np.zeros(shape, np.float32)
    a[rows] = rs.randn(len(rows), *shape[1:]).astype(np.float32)
    return a


def _same(t, j):
    np.testing.assert_array_equal(t.asnumpy(), j.asnumpy())
    assert t.shape == tuple(j.shape) and t.stype == j.stype


def test_constructors_match_jax():
    rs = np.random.RandomState(0)
    vals = rs.randn(3, 4).astype(np.float32)
    rows = np.array([1, 4, 6])
    with tmx.cpu():
        t = tsp.row_sparse_array((vals, rows), shape=(8, 4))
        t_auto = tsp.row_sparse_array((vals, rows))
    j = jsp.row_sparse_array((vals, rows), shape=(8, 4))
    _same(t, j)
    assert t_auto.shape == (7, 4)
    np.testing.assert_array_equal(t.indices.asnumpy(), rows)
    assert t.data is t.data and t.data.shape == (3, 4)
    assert not isinstance(t, tmx.NDArray)
    dense = _dense(rs, (5, 7))
    csr_j = jsp.csr_matrix(dense)
    with tmx.cpu():
        csr_t = tsp.csr_matrix(dense)
        triple = tsp.csr_matrix((csr_j.data.asnumpy(),
                                 csr_j.indices.asnumpy(),
                                 csr_j.indptr.asnumpy()), shape=(5, 7))
    for got in (csr_t, triple):
        _same(got, csr_j)
        for a in ("data", "indices", "indptr"):
            np.testing.assert_array_equal(getattr(got, a).asnumpy(),
                                          getattr(csr_j, a).asnumpy())
    with pytest.raises(tmx.MXNetError, match="needs shape"):
        tsp.csr_matrix((vals, rows, rows), ctx="cpu")


@pytest.mark.parametrize("src", ["default", "row_sparse", "csr"])
@pytest.mark.parametrize("dst", ["default", "row_sparse", "csr"])
def test_cast_storage_round_trips_match_jax(src, dst):
    rs = np.random.RandomState(1)
    dense = _rsp_dense(rs, (9, 5), [0, 3, 4, 8])
    dense[3, 1] = 0.0
    j = jmx.nd.array(dense)
    with tmx.cpu():
        t = nd.array(dense)
    if src != "default":
        j, t = j.tostype(src), t.tostype(src)
    jo, to = jsp.cast_storage(j, dst), tsp.cast_storage(t, dst)
    _same(to, jo)
    if dst == "row_sparse":
        np.testing.assert_array_equal(to.indices.asnumpy(),
                                      jo.indices.asnumpy())
        np.testing.assert_array_equal(to.data.asnumpy(), jo.data.asnumpy())
    np.testing.assert_array_equal(to.tostype("default").asnumpy(), dense)
    assert t.tostype(t.stype) is t


@pytest.mark.parametrize("stype", ["row_sparse", "csr", "default"])
def test_zeros_match_jax(stype):
    j = jsp.zeros(stype, (4, 3))
    with tmx.cpu():
        t = tsp.zeros(stype, (4, 3))
    _same(t, j)


def test_retain_matches_jax():
    rs = np.random.RandomState(2)
    dense = _rsp_dense(rs, (10, 3), [1, 2, 5, 7, 9])
    j = jsp.retain(jmx.nd.array(dense).tostype("row_sparse"),
                   jmx.nd.array(np.array([2, 7, 8], np.int64)))
    with tmx.cpu():
        t = tsp.retain(nd.array(dense).tostype("row_sparse"),
                       nd.array(np.array([2, 7, 8], np.int64)))
    _same(t, j)
    np.testing.assert_array_equal(t.indices.asnumpy(), [2, 7])
    with pytest.raises(tmx.MXNetError, match="row_sparse"):
        tsp.retain(nd.array(dense, ctx="cpu"), [1])


@pytest.mark.parametrize("transpose_a", [False, True])
def test_sparse_dot_matches_jax(transpose_a):
    rs = np.random.RandomState(3)
    dense = _dense(rs, (12, 20))
    rhs = rs.randn(12 if transpose_a else 20, 6).astype(np.float32)
    j = jsp.dot(jsp.csr_matrix(dense), jmx.nd.array(rhs),
                transpose_a=transpose_a)
    with tmx.cpu():
        csr = tsp.csr_matrix(dense)
        w = nd.array(rhs)
        w.attach_grad()
        with tmx.autograd.record():
            t = tsp.dot(csr, w, transpose_a=transpose_a)
        t.backward()
    np.testing.assert_allclose(t.asnumpy(), j.asnumpy(), rtol=TOL, atol=TOL)
    lhs = dense.T if transpose_a else dense
    np.testing.assert_allclose(t.asnumpy(), lhs @ rhs, rtol=1e-5, atol=1e-5)
    # d(sum(lhs @ w))/dw = column sums of lhs, broadcast over w's columns
    np.testing.assert_allclose(w.grad.asnumpy(),
                               np.repeat(lhs.sum(0)[:, None], 6, 1),
                               rtol=1e-5, atol=1e-5)
    # a dense pair densifies and takes the registry's dot
    with tmx.cpu():
        d = tsp.dot(nd.array(dense), nd.array(rs.randn(20, 2)
                                              .astype(np.float32)))
    assert d.shape == (12, 2)


def test_csr_to_ell_matches_jax():
    rs = np.random.RandomState(4)
    dense = _dense(rs, (6, 9), 0.3)
    jc = jsp.csr_matrix(dense)
    with tmx.cpu():
        tc = tsp.csr_matrix(dense)
    for k in (None, 9):
        jcols, jvals = jsp.csr_to_ell(jc, k)
        tcols, tvals = tsp.csr_to_ell(tc, k)
        np.testing.assert_array_equal(tcols.asnumpy(), jcols.asnumpy())
        np.testing.assert_array_equal(tvals.asnumpy(), jvals.asnumpy())
        assert tcols.dtype == torch.int32
    with pytest.raises(tmx.MXNetError, match="nnz"):
        tsp.csr_to_ell(tc, 1)


RSP_UPDATES = [
    ("sgd_update_rsp", 0, dict(lr=0.1, wd=0.01, rescale_grad=0.5)),
    ("sgd_mom_update_rsp", 1, dict(lr=0.1, momentum=0.9, wd=0.01,
                                   clip_gradient=0.4)),
    ("adam_update_rsp", 2, dict(lr=0.01, beta1=0.8, wd=0.01,
                                rescale_grad=2.0)),
    ("adagrad_update_rsp", 1, dict(lr=0.1, epsilon=1e-6, wd=0.01)),
]


@pytest.mark.parametrize("name,n_states,kw", RSP_UPDATES)
def test_lazy_row_updates_match_jax(name, n_states, kw):
    rs = np.random.RandomState(5)
    w0 = rs.randn(10, 3).astype(np.float32)
    states = [rs.rand(10, 3).astype(np.float32) for _ in range(n_states)]
    rows = np.array([1, 4, 7], np.int64)
    g = rs.randn(3, 3).astype(np.float32)
    jw = jmx.nd.array(w0)
    js = [jmx.nd.array(s) for s in states]
    getattr(jsp, name)(jw, jsp.row_sparse_array((g, rows), shape=(10, 3)),
                       *js, **kw)
    with tmx.cpu():
        tw = nd.array(w0)
        ts = [nd.array(s) for s in states]
        grad = tsp.row_sparse_array((g, rows), shape=(10, 3))
    getattr(tsp, name)(tw, grad, *ts, **kw)
    for got, want in zip([tw] + ts, [jw] + js):
        np.testing.assert_allclose(got.asnumpy(), want.asnumpy(), rtol=TOL,
                                   atol=TOL)
    untouched = np.setdiff1d(np.arange(10), rows)
    np.testing.assert_array_equal(tw.asnumpy()[untouched], w0[untouched])
    for got, s in zip(ts, states):
        np.testing.assert_array_equal(got.asnumpy()[untouched],
                                      s[untouched])
    assert not np.array_equal(tw.asnumpy()[rows], w0[rows])


def test_sgd_mom_update_rsp_matches_the_dense_op_under_a_schedule():
    """tests/test_ndarray.py:198: the lazy momentum keeps the dense
    op's lr-inside convention, so under an lr schedule the touched rows
    follow the dense op's trajectory."""
    rng = np.random.RandomState(7)
    n, d = 10, 4
    w0 = rng.randn(n, d).astype(np.float32)
    m0 = rng.randn(n, d).astype(np.float32)
    rows = np.array([1, 4, 7])
    g = rng.randn(len(rows), d).astype(np.float32)
    with tmx.cpu():
        w_s, m_s = nd.array(w0.copy()), nd.array(m0.copy())
        grad = tsp.row_sparse_array((g, rows), shape=(n, d))
        w_d, m_d = nd.array(w0[rows].copy()), nd.array(m0[rows].copy())
        for lr in (0.1, 0.03):
            tsp.sgd_mom_update_rsp(w_s, grad, m_s, lr=lr, momentum=0.9,
                                   wd=0.01)
            nd.sgd_mom_update(w_d, nd.array(g), m_d, lr=lr, momentum=0.9,
                              wd=0.01, out=w_d)
    np.testing.assert_allclose(w_s.asnumpy()[rows], w_d.asnumpy(),
                               rtol=TOL, atol=TOL)
    np.testing.assert_allclose(m_s.asnumpy()[rows], m_d.asnumpy(),
                               rtol=TOL, atol=TOL)


def test_sparse_array_methods():
    with tmx.cpu():
        rsp = tsp.row_sparse_array((np.ones((2, 3), np.float32), [0, 2]),
                                   shape=(4, 3))
        dense = nd.zeros((4, 3))
    assert nd.array([1.0], ctx="cpu").stype == "default"
    assert rsp.context == tmx.cpu() and rsp.dtype == torch.float32
    assert rsp.astype("float64").dtype == torch.float64
    c = rsp.copy()
    c.data[:] = 5.0
    assert rsp.data.asnumpy().max() == 1.0
    rsp.copyto(dense)
    np.testing.assert_array_equal(dense.asnumpy()[[0, 2]], 1.0)
    other = tsp.zeros("row_sparse", (4, 3), ctx="cpu")
    rsp.copyto(other)
    np.testing.assert_array_equal(other.indices.asnumpy(), [0, 2])
    assert "RowSparseNDArray 4x3 (2 rows)" in repr(rsp)


# -- LibSVMIter: tests/test_io.py:311-371's files ---------------------------
def _write(path, lines):
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")


def _batches(it):
    out = []
    for b in it:
        out.append((b.data[0].asnumpy(), b.label[0].asnumpy(), b.pad,
                    b.data[0].stype))
    return out


LIBSVM_CASES = {
    "csr": (["1 0:1.5 3:2.0", "0 1:3.0", "2 0:0.5 2:1.0 4:4.0", "1 4:1.0"],
            dict(data_shape=(5,), batch_size=2), None),
    "round_batch": (["0 0:1.0", "1 1:1.0", "0 2:1.0"],
                    dict(data_shape=(4,), batch_size=2), None),
    "label_file": (["0 0:1.0", "0 1:2.0"],
                   dict(data_shape=(2,), label_shape=(3,), batch_size=2),
                   ["0:1.0 2:5.0", "1:3.0"]),
    "sharding": ([f"{i} {i % 3}:1.0" for i in range(8)],
                 dict(data_shape=(3,), batch_size=2, num_parts=2,
                      part_index=1), None),
}


@pytest.mark.parametrize("case", sorted(LIBSVM_CASES))
def test_libsvm_iter_matches_jax(tmp_path, case):
    lines, kw, label_lines = LIBSVM_CASES[case]
    p = str(tmp_path / "d.libsvm")
    _write(p, lines)
    if label_lines is not None:
        kw = dict(kw, label_libsvm=str(tmp_path / "l.libsvm"))
        _write(kw["label_libsvm"], label_lines)
    jit = jmx.io.LibSVMIter(data_libsvm=p, **kw)
    tit = tmx.io.LibSVMIter(data_libsvm=p, ctx=tmx.cpu(), **kw)
    assert tit.max_row_nnz == jit.max_row_nnz
    assert tit.num_data == jit.num_data
    for _ in range(2):                  # and again after reset()
        got, want = _batches(tit), _batches(jit)
        assert len(got) == len(want) > 0
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g[0], w[0])
            np.testing.assert_array_equal(g[1], w[1])
            assert g[2:] == w[2:] and g[3] == "csr"
        tit.reset()
        jit.reset()


def test_libsvm_iter_rejects_one_based_ids(tmp_path):
    p = str(tmp_path / "d.libsvm")
    _write(p, ["0 7:1.0"])
    with pytest.raises(tmx.MXNetError, match="ZERO-based"):
        tmx.io.LibSVMIter(data_libsvm=p, data_shape=(5,), batch_size=1,
                          ctx=tmx.cpu())


def _iter_batches(it):
    return [([d.asnumpy() for d in b.data],
             [lb.asnumpy() for lb in (b.label or [])], b.pad) for b in it]


def _same_batches(got, want):
    assert len(got) == len(want) > 0
    for (gd, gl, gp), (wd, wl, wp) in zip(got, want):
        assert gp == wp
        for a, b in zip(gd + gl, wd + wl):
            np.testing.assert_array_equal(a, b)


def _mnist_files(tmp_path, n=20):
    rs = np.random.RandomState(6)
    img = rs.randint(0, 256, (n, 28, 28)).astype(np.uint8)
    lbl = rs.randint(0, 10, n).astype(np.uint8)
    paths = []
    for name, arr in (("img.gz", img), ("lbl.gz", lbl)):
        path = str(tmp_path / name)
        with gzip.open(path, "wb") as f:
            f.write(struct.pack(">HBB", 0, 8, arr.ndim))
            for s in arr.shape:
                f.write(struct.pack(">I", s))
            f.write(arr.tobytes())
        paths.append(path)
    return paths


@pytest.mark.parametrize("kind", ["ndarray_pad", "ndarray_discard",
                                  "ndarray_roll_over", "csv", "resize",
                                  "prefetch", "mnist"])
def test_data_iterators_match_jax(tmp_path, kind):
    rs = np.random.RandomState(8)
    x = rs.rand(10, 3).astype(np.float32)
    y = rs.randint(0, 3, 10).astype(np.float32)

    def make(io, ctx):
        if kind.startswith("ndarray"):
            return io.NDArrayIter(x, y, batch_size=4, ctx=ctx,
                                  last_batch_handle=kind.split("_", 1)[1])
        if kind == "csv":
            xp, yp = str(tmp_path / "x.csv"), str(tmp_path / "y.csv")
            np.savetxt(xp, x, delimiter=",")
            np.savetxt(yp, y, delimiter=",")
            return io.CSVIter(data_csv=xp, data_shape=(3,), label_csv=yp,
                              batch_size=3, round_batch=False, ctx=ctx)
        if kind == "resize":
            return io.ResizeIter(io.NDArrayIter(x, y, batch_size=4, ctx=ctx),
                                 size=5)
        if kind == "prefetch":
            return io.PrefetchingIter(io.NDArrayIter(x, y, batch_size=5,
                                                     ctx=ctx))
        img, lbl = _mnist_files(tmp_path)
        return io.MNISTIter(image=img, label=lbl, batch_size=8,
                            shuffle=False, flat=True, ctx=ctx)

    want = _iter_batches(make(jmx.io, jmx.cpu()))
    got = _iter_batches(make(tmx.io, tmx.cpu()))
    _same_batches(got, want)


def test_image_record_iter_is_not_ported_yet():
    """Both readers are ported now: the native one
    (``ImageRecordIterNative``, ``tests/test_torch_native_io.py``)
    refuses a file it cannot open when it is made, and
    ``ImageRecordIter`` without an index is the Python pipeline
    (``image.py``), which opens the file
    (``tests/test_torch_image_io.py`` reads records)."""
    with pytest.raises(IOError, match="cannot open no-such.rec"):
        tmx.io.ImageRecordIterNative(path_imgrec="no-such.rec",
                                     path_imgidx="no-such.idx",
                                     data_shape=(3, 8, 8), batch_size=2,
                                     ctx=tmx.cpu())
    with pytest.raises(FileNotFoundError):
        tmx.io.ImageRecordIter(path_imgrec="no-such.rec",
                               data_shape=(3, 8, 8), batch_size=2)
