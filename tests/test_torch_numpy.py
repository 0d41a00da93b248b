"""``mx.np`` and ``mx.npx`` of the PyTorch port against the JAX package,
on the CPU.

- The golden table of ``tests/test_numpy.py`` (copied: every
  ``_npi_*`` op of the JAX registry is dispatched by a row): each row
  runs in both packages on the same numpy-seeded inputs; values agree
  within rtol 1e-4 / atol 1e-5 (float32 functions computed in another
  order; the linear algebra within 1e-3), and the dtypes are equal.
  Each also matches real NumPy as the JAX test holds it.
- Creation, manipulation, ``nonzero``/``unique``/``histogram``, the
  linear algebra (reconstructions for the sign-free ``svd``/``qr``) and
  the tail functions, against the JAX package's results.
- ``np.random`` by properties (means, supports, counts): the bits
  differ from ``jax.random``'s by design.
- The ``ndarray`` type: zero-dim results, boolean masks, bool
  comparisons, ``tolist``, pickling, the class kept by torch's ops and
  dunders, ``dtype == np.float32``, ``size`` as an int.
- Interop and the tape: ``as_nd_ndarray``/``as_np_ndarray`` share the
  storage and, under ``record()``, carry gradients across; autograd
  through ``einsum``, ``tensordot`` and ``linalg.solve`` against the
  JAX package's gradients.
- ``npx``'s operators against the JAX package's, ``npx.save`` files
  loaded by the other package, and ``mx.sym.np``/``mx.sym.npx`` graphs
  (with a JSON round trip) giving the JAX package's outputs and raising
  its errors.

``npx.set_np()`` is process-wide in both packages: an autouse fixture
resets it after every test and checks that it is off.
"""
import pickle

import numpy as onp
import pytest
import torch

import mxnet_tpu as jmx
from mxnet_tpu import util as jutil
import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import util

torch.set_num_threads(1)

tnp, tnpx = tmx.np, tmx.npx
jnp_, jnpx = jmx.np, jmx.npx


@pytest.fixture(autouse=True)
def _np_mode_off_on_the_cpu():
    with tmx.cpu():
        yield
    tnpx.reset_np()
    jnpx.reset_np()
    assert not util.is_np_array() and not util.is_np_shape()
    assert not jutil.is_np_array() and not jutil.is_np_shape()


RS = onp.random.RandomState(7)


def _a(*shape):
    return RS.randn(*shape).astype(onp.float32)


def _pos(*shape):
    return (RS.rand(*shape) + 0.5).astype(onp.float32)


def _i(*shape, high=5):
    return RS.randint(0, high, size=shape).astype(onp.int32)


def _c(*shape):
    """Data of ``shape`` from a seed of its own: the same in both
    packages' calls of one lambda."""
    rs = onp.random.RandomState(1000 + 37 * len(shape) + sum(shape))
    return rs.randn(*shape).astype(onp.float32)


def _vals(x):
    """``[(numpy value, dtype name)]`` of a result (arrays, tuples,
    Python values)."""
    if isinstance(x, (list, tuple)):
        return [v for e in x for v in _vals(e)]
    if hasattr(x, "asnumpy"):
        return [(x.asnumpy(), str(x.dtype))]
    return [(onp.asarray(x), None)]


def same(got, want, rtol=1e-4, atol=1e-5, dtypes=True):
    """The port's result ``got`` against the JAX package's ``want``."""
    g, w = _vals(got), _vals(want)
    assert len(g) == len(w), (len(g), len(w))
    for (ga, gd), (wa, wd) in zip(g, w):
        assert ga.shape == wa.shape, (ga.shape, wa.shape)
        if dtypes:
            assert gd == wd, (gd, wd)
        if wa.dtype == onp.bool_:
            assert (ga == wa).all()
        else:
            onp.testing.assert_allclose(ga.astype(onp.float64),
                                        wa.astype(onp.float64),
                                        rtol=rtol, atol=atol)


def golden(got, want, rtol=1e-4, atol=1e-4):
    """A result against real NumPy's (as ``tests/test_numpy.py``)."""
    for (ga, _), w in zip(_vals(got), [want] if not isinstance(
            want, (list, tuple)) else want):
        w = onp.asarray(w)
        assert ga.shape == w.shape, (ga.shape, w.shape)
        if w.dtype == onp.bool_:
            assert (ga == w).all()
        else:
            onp.testing.assert_allclose(ga.astype(onp.float64),
                                        w.astype(onp.float64),
                                        rtol=rtol, atol=atol)


# ---------------------------------------------------------------------------
# the golden table (copied from tests/test_numpy.py; the lambdas take the
# namespace)
# ---------------------------------------------------------------------------
_X = _a(3, 4)
_Y = _a(3, 4)
_P = _pos(3, 4)
_SQ = (lambda m: m @ m.T + 3 * onp.eye(3).astype(onp.float32))(_a(3, 3))
_V = _a(6)
_I8 = _i(3, 4, high=4)
_B = RS.rand(3, 4) > 0.5
_C1, _C2 = _a(4, 3), _a(4, 3)

CASES = [
    ("add", lambda n: n.add(_X, _Y), onp.add(_X, _Y)),
    ("subtract", lambda n: n.subtract(_X, _Y), onp.subtract(_X, _Y)),
    ("multiply", lambda n: n.multiply(_X, _Y), onp.multiply(_X, _Y)),
    ("divide", lambda n: n.divide(_X, _P), onp.divide(_X, _P)),
    ("floor_divide", lambda n: n.floor_divide(_X, _P), _X // _P),
    ("mod", lambda n: n.mod(_X, _P), onp.mod(_X, _P)),
    ("fmod", lambda n: n.fmod(_X, _P), onp.fmod(_X, _P)),
    ("power", lambda n: n.power(_P, _Y), onp.power(_P, _Y)),
    ("maximum", lambda n: n.maximum(_X, _Y), onp.maximum(_X, _Y)),
    ("minimum", lambda n: n.minimum(_X, _Y), onp.minimum(_X, _Y)),
    ("fmax", lambda n: n.fmax(_X, _Y), onp.fmax(_X, _Y)),
    ("fmin", lambda n: n.fmin(_X, _Y), onp.fmin(_X, _Y)),
    ("hypot", lambda n: n.hypot(_X, _Y), onp.hypot(_X, _Y)),
    ("arctan2", lambda n: n.arctan2(_X, _P), onp.arctan2(_X, _P)),
    ("logaddexp", lambda n: n.logaddexp(_X, _Y), onp.logaddexp(_X, _Y)),
    ("logaddexp2", lambda n: n.logaddexp2(_X, _Y), onp.logaddexp2(_X, _Y)),
    ("copysign", lambda n: n.copysign(_P, _X), onp.copysign(_P, _X)),
    ("ldexp", lambda n: n.ldexp(_X, _I8), onp.ldexp(_X, _I8)),
    ("heaviside", lambda n: n.heaviside(_X, _P), onp.heaviside(_X, _P)),
    ("gcd", lambda n: n.gcd(_I8, _I8 + 2), onp.gcd(_I8, _I8 + 2)),
    ("lcm", lambda n: n.lcm(_I8 + 1, _I8 + 2), onp.lcm(_I8 + 1, _I8 + 2)),
    ("bitwise_and", lambda n: n.bitwise_and(_I8, _I8 + 1),
     onp.bitwise_and(_I8, _I8 + 1)),
    ("bitwise_or", lambda n: n.bitwise_or(_I8, _I8 + 1),
     onp.bitwise_or(_I8, _I8 + 1)),
    ("bitwise_xor", lambda n: n.bitwise_xor(_I8, _I8 + 1),
     onp.bitwise_xor(_I8, _I8 + 1)),
    ("invert", lambda n: n.invert(_I8), onp.invert(_I8)),
    ("left_shift", lambda n: n.left_shift(_I8, 2), onp.left_shift(_I8, 2)),
    ("right_shift", lambda n: n.right_shift(_I8, 1),
     onp.right_shift(_I8, 1)),
    ("equal", lambda n: n.equal(_I8, 2), onp.equal(_I8, 2)),
    ("not_equal", lambda n: n.not_equal(_I8, 2), onp.not_equal(_I8, 2)),
    ("greater", lambda n: n.greater(_X, _Y), onp.greater(_X, _Y)),
    ("greater_equal", lambda n: n.greater_equal(_X, _Y),
     onp.greater_equal(_X, _Y)),
    ("less", lambda n: n.less(_X, _Y), onp.less(_X, _Y)),
    ("less_equal", lambda n: n.less_equal(_X, _Y), onp.less_equal(_X, _Y)),
    ("logical_and", lambda n: n.logical_and(_B, ~_B),
     onp.logical_and(_B, ~_B)),
    ("logical_or", lambda n: n.logical_or(_B, ~_B), onp.logical_or(_B, ~_B)),
    ("logical_xor", lambda n: n.logical_xor(_B, _B),
     onp.logical_xor(_B, _B)),
    ("logical_not", lambda n: n.logical_not(_B), onp.logical_not(_B)),
    ("isclose", lambda n: n.isclose(_X, _X + 1e-8),
     onp.isclose(_X, _X + 1e-8)),
    ("signbit", lambda n: n.signbit(_X), onp.signbit(_X)),
    ("exp2", lambda n: n.exp2(_X), onp.exp2(_X)),
    ("nan_to_num", lambda n: n.nan_to_num(
        n.array([[1.0, onp.nan, onp.inf]])),
     onp.nan_to_num(onp.array([[1.0, onp.nan, onp.inf]], onp.float32))),
    ("positive", lambda n: n.positive(_X), _X),
    ("deg2rad", lambda n: n.deg2rad(_X), onp.deg2rad(_X)),
    ("std", lambda n: n.std(_X, axis=1), onp.std(_X, axis=1)),
    ("std_ddof", lambda n: n.std(_X, ddof=1), onp.std(_X, ddof=1)),
    ("var", lambda n: n.var(_X, axis=0), onp.var(_X, axis=0)),
    ("median", lambda n: n.median(_X, axis=1), onp.median(_X, axis=1)),
    ("quantile", lambda n: n.quantile(_X, 0.25), onp.quantile(_X, 0.25)),
    ("percentile", lambda n: n.percentile(_X, 75, axis=0),
     onp.percentile(_X, 75, axis=0)),
    ("average", lambda n: n.average(_X, axis=0, weights=_P[:, 0]),
     onp.average(_X, axis=0, weights=_P[:, 0])),
    ("cumprod", lambda n: n.cumprod(_P, axis=1), onp.cumprod(_P, axis=1)),
    ("all", lambda n: n.all(_B, axis=0), onp.all(_B, axis=0)),
    ("any", lambda n: n.any(_B, axis=1), onp.any(_B, axis=1)),
    ("count_nonzero", lambda n: n.count_nonzero(_I8, axis=1),
     onp.count_nonzero(_I8, axis=1)),
    ("ptp", lambda n: n.ptp(_X, axis=1), onp.ptp(_X, axis=1)),
    ("diff", lambda n: n.diff(_X, axis=1), onp.diff(_X, axis=1)),
    ("ediff1d", lambda n: n.ediff1d(_V), onp.ediff1d(_V)),
    ("bincount", lambda n: n.bincount(n.array(_I8.ravel()), minlength=6),
     onp.bincount(_I8.ravel(), minlength=6)),
    ("nanmax", lambda n: n.nanmax(_X, axis=0), onp.nanmax(_X, axis=0)),
    ("nanmin", lambda n: n.nanmin(_X, axis=0), onp.nanmin(_X, axis=0)),
    ("nanmean", lambda n: n.nanmean(_X, axis=1), onp.nanmean(_X, axis=1)),
    ("roll", lambda n: n.roll(_X, 2, axis=1), onp.roll(_X, 2, axis=1)),
    ("rot90", lambda n: n.rot90(_X), onp.rot90(_X)),
    ("moveaxis", lambda n: n.moveaxis(n.array(_c(2, 3, 4)), 0, 2),
     onp.zeros((3, 4, 2))),
    ("tril", lambda n: n.tril(_X), onp.tril(_X)),
    ("triu", lambda n: n.triu(_X, 1), onp.triu(_X, 1)),
    ("trace", lambda n: n.trace(_X), onp.trace(_X)),
    ("diagonal", lambda n: n.diagonal(_X, 1), onp.diagonal(_X, 1)),
    ("diagflat", lambda n: n.diagflat(_V[:3]), onp.diagflat(_V[:3])),
    ("searchsorted", lambda n: n.searchsorted(n.array(onp.sort(_V)), 0.1),
     onp.searchsorted(onp.sort(_V), onp.float32(0.1))),
    ("take_along_axis", lambda n: n.take_along_axis(
        _X, n.array(onp.argsort(_X, 1)), 1),
     onp.take_along_axis(_X, onp.argsort(_X, 1), 1)),
    ("pad", lambda n: n.pad(_X, ((1, 1), (2, 0))),
     onp.pad(_X, ((1, 1), (2, 0)))),
    ("append", lambda n: n.append(_X, _Y, axis=0),
     onp.append(_X, _Y, axis=0)),
    ("where3", lambda n: n.where(n.array(_B), _X, _Y), onp.where(_B, _X, _Y)),
    ("interp", lambda n: n.interp(n.array([0.5, 1.5]),
                                  n.array([0.0, 1.0, 2.0]),
                                  n.array([10.0, 20.0, 30.0])),
     onp.interp([0.5, 1.5], [0, 1, 2], [10.0, 20.0, 30.0]).astype("f")),
    ("cross", lambda n: n.cross(_C1, _C2, axis=1),
     onp.cross(_C1, _C2, axis=1)),
    ("kron", lambda n: n.kron(_X[:2, :2], _Y[:2, :2]),
     onp.kron(_X[:2, :2], _Y[:2, :2])),
    ("flip", lambda n: n.flip(_X), onp.flip(_X)),
    ("fliplr", lambda n: n.fliplr(_X), onp.fliplr(_X)),
    ("flipud", lambda n: n.flipud(_X), onp.flipud(_X)),
    ("dot", lambda n: n.dot(_X, _Y.T), onp.dot(_X, _Y.T)),
    ("vdot", lambda n: n.vdot(_X, _Y), onp.vdot(_X, _Y)),
    ("inner", lambda n: n.inner(_X, _Y), onp.inner(_X, _Y)),
    ("outer", lambda n: n.outer(_V, _V), onp.outer(_V, _V)),
    ("matmul", lambda n: n.matmul(_X, _Y.T), onp.matmul(_X, _Y.T)),
    ("tensordot", lambda n: n.tensordot(_X, _Y, axes=([1], [1])),
     onp.tensordot(_X, _Y, axes=([1], [1]))),
    ("einsum", lambda n: n.einsum("ij,kj->ik", _X, _Y),
     onp.einsum("ij,kj->ik", _X, _Y)),
]


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_np_golden_matches_jax_in_values_and_dtypes(case):
    name, fn, want = case
    got = fn(tnp)
    assert type(got).__name__ == "ndarray"
    same(got, fn(jnp_))
    if name == "moveaxis":
        assert tuple(got.shape) == want.shape
    else:
        golden(got, want)


# ---------------------------------------------------------------------------
# the rest of the function surface
# ---------------------------------------------------------------------------
def _both(fn, **kw):
    same(fn(tnp), fn(jnp_), **kw)


def test_np_creation_matches_jax():
    for fn in (lambda n: n.zeros((2, 3)), lambda n: n.ones(4),
               lambda n: n.full((2, 2), 7.0), lambda n: n.full((2,), 3),
               lambda n: n.arange(2, 10, 2), lambda n: n.arange(0, 1, 0.25),
               lambda n: n.linspace(0, 1, 5), lambda n: n.logspace(0, 2, 3),
               lambda n: n.eye(3, k=1), lambda n: n.identity(2),
               lambda n: n.zeros_like(n.array(_X)),
               lambda n: n.ones_like(n.array(_I8)),
               lambda n: n.full_like(n.array(_X), 3.5),
               lambda n: n.empty_like(n.array(_X)),
               lambda n: n.array([1.5, 2.5]),
               lambda n: n.array(onp.ones(3, onp.int64)),
               lambda n: n.array(3.5), lambda n: n.array([True, False]),
               lambda n: n.tri(3, 5, 1), lambda n: n.indices((2, 3)),
               lambda n: n.tril_indices(4, 1), lambda n: n.triu_indices(3),
               lambda n: n.hanning(8), lambda n: n.hamming(8),
               lambda n: n.blackman(8)):
        _both(fn)
    r, step = tnp.linspace(0, 1, 5, retstep=True)
    assert step == 0.25 and r.dtype == onp.float32


def test_np_manipulation_matches_jax():
    x3 = _c(2, 3, 4)
    cases = [
        lambda n: n.array(x3).reshape(4, 6), lambda n: n.ravel(n.array(x3)),
        lambda n: n.array(x3).flatten(),
        lambda n: n.concatenate([n.array(x3), n.array(x3)], axis=1),
        lambda n: n.concatenate([n.array(x3), n.array(x3)], axis=None),
        lambda n: n.stack([n.array(x3)] * 2, axis=1),
        lambda n: n.vstack([_X, _Y]), lambda n: n.hstack([_X, _Y]),
        lambda n: n.dstack([_X, _Y]), lambda n: n.column_stack([_V, _V]),
        lambda n: n.row_stack([_X, _Y]),
        lambda n: n.split(n.array(_V), 3),
        lambda n: n.array_split(n.array(_c(7)), 3),
        lambda n: n.hsplit(n.array(_X), 2), lambda n: n.vsplit(n.array(_X), 3),
        lambda n: n.dsplit(n.array(_c(2, 4, 6)), 3),
        lambda n: n.broadcast_to(n.array(_V), (3, 6)),
        lambda n: n.broadcast_arrays(n.array(_V), n.array(_c(3, 1))),
        lambda n: n.atleast_1d(n.array(3.0)),
        lambda n: n.atleast_2d(n.array(_V)),
        lambda n: n.atleast_3d(n.array(_X)),
        lambda n: n.meshgrid(n.array([1.0, 2.0]), n.array([3.0, 4.0, 5.0])),
        lambda n: n.meshgrid(n.array([1.0, 2.0]), n.array([3.0, 4.0, 5.0]),
                             indexing="ij"),
        lambda n: n.transpose(n.array(x3), (2, 0, 1)),
        lambda n: n.array(x3).transpose(1, 0, 2),
        lambda n: n.array(x3).T, lambda n: n.swapaxes(n.array(x3), 0, 2),
        lambda n: n.expand_dims(n.array(_X), 1),
        lambda n: n.squeeze(n.array(_c(1, 3, 1)), axis=0),
        lambda n: n.tile(n.array(_V), (2, 1)),
        lambda n: n.repeat(n.array(_X), 2, axis=1),
        lambda n: n.take(n.array(_X), n.array(onp.array([1, 2], "int32")),
                         axis=1),
        lambda n: n.take(n.array(_X), n.array(onp.array([0, 5], "int32"))),
        lambda n: n.clip(n.array(_X), -0.5, 0.5),
        lambda n: n.clip(n.array(_X), None, 0.0),
        lambda n: n.clip(n.array(_X), 0.0, None),
        lambda n: n.sort(n.array(_X), axis=0),
        lambda n: n.argsort(n.array(_X)), lambda n: n.argmax(n.array(_X), 1),
        lambda n: n.argmin(n.array(_X)), lambda n: n.where(n.array(_X) > 0),
        lambda n: n.rollaxis(n.zeros((2, 3, 4)), 2, 0),
        lambda n: n.delete(n.arange(5), 2),
        lambda n: n.insert(n.arange(4), 1, 9),
        lambda n: n.diag_indices_from(n.array(_SQ)),
        lambda n: n.unravel_index(n.array([5, 7], dtype="int32"), (2, 4)),
        lambda n: n.pad(n.array(_X), 1, mode="edge"),
        lambda n: n.pad(n.array(_X), ((0, 2), (1, 1)), mode="reflect"),
    ]
    for fn in cases:
        _both(fn)


def test_np_reductions_and_math_match_jax():
    x, i = _X, _I8
    cases = [
        lambda n: n.sum(n.array(x), axis=0), lambda n: n.array(x).sum(),
        lambda n: n.sum(n.array(i)), lambda n: n.prod(n.array(i), axis=1),
        lambda n: n.mean(n.array(x), axis=1, keepdims=True),
        lambda n: n.array(i).mean(), lambda n: n.max(n.array(x), axis=0),
        lambda n: n.amin(n.array(i)), lambda n: n.array(x).std(ddof=1),
        lambda n: n.array(x).var(axis=1), lambda n: n.cumsum(n.array(x)),
        lambda n: n.array(i).cumsum(axis=1), lambda n: n.nansum(n.array(x)),
        lambda n: n.nanprod(n.array(_P)), lambda n: n.std(n.array(i)),
        lambda n: n.median(n.array(i)),
        lambda n: n.quantile(n.array(x), 0.5, axis=0, keepdims=True),
        lambda n: n.around(n.array(x), 2), lambda n: n.round(n.array(x)),
        lambda n: n.array(x).round(1),
        lambda n: n.isposinf(n.array([onp.inf, -onp.inf, 1.0])),
        lambda n: n.isneginf(n.array([onp.inf, -onp.inf, 1.0])),
        lambda n: n.float_power(n.array([2.0]), n.array([3.0])),
        lambda n: n.polyval(n.array([1.0, 0.0, -1.0]), n.array([2.0, 3.0])),
        lambda n: n.vander(n.array([1.0, 2.0, 3.0])),
        lambda n: n.vander(n.array([1.0, 2.0, 3.0]), 4, increasing=True),
        lambda n: n.argwhere(n.array(onp.array([[0, 1], [2, 0]], "f"))),
        lambda n: n.flatnonzero(n.array(i)), lambda n: n.nonzero(n.array(i)),
        lambda n: n.unique(n.array([3, 1, 2, 3, 1])),
        lambda n: n.unique(n.array([3, 1, 2, 3, 1]), return_index=True,
                           return_inverse=True, return_counts=True),
        lambda n: n.histogram(n.array(_V), bins=4),
        lambda n: n.sign(n.array(i)), lambda n: n.sqrt(n.array(i)),
        lambda n: n.true_divide(n.array(i), 2),
        lambda n: n.array(i) / n.array(i + 1),
        lambda n: n.dot(n.array(i), n.array(i).T),
        lambda n: n.tensordot(n.array(i), n.array(i), axes=([0, 1], [0, 1])),
        lambda n: n.abs(n.array(i)), lambda n: n.negative(n.array(i)),
    ]
    for fn in cases:
        _both(fn)
    _both(lambda n: n.percentile(n.array(i), 50))
    assert tnp.allclose(tnp.array(_X), tnp.array(_X + 1e-9))
    assert tnp.array_equal(tnp.array(_V), tnp.array(_V))
    assert not tnp.array_equal(tnp.array(_V), tnp.array(_V[:3]))
    buf = tnp.zeros(2)
    assert tnp.around(tnp.array([1.234, 5.678]), 2, out=buf) is buf
    golden(buf, onp.array([1.23, 5.68], "f"))


def test_np_linalg_matches_jax():
    sq, a = _SQ, _c(4, 3)
    for fn in (lambda n: n.linalg.inv(n.array(sq)),
               lambda n: n.linalg.det(n.array(sq)),
               lambda n: n.linalg.slogdet(n.array(sq)),
               lambda n: n.linalg.cholesky(n.array(sq)),
               lambda n: n.linalg.solve(n.array(sq), n.array(_c(3, 2))),
               lambda n: n.linalg.solve(n.array(sq), n.array(_V[:3])),
               lambda n: n.linalg.eigvalsh(n.array(sq)),
               lambda n: n.linalg.eigh(n.array(sq))[0],
               lambda n: n.linalg.pinv(n.array(a)),
               lambda n: n.linalg.matrix_rank(n.array(a)),
               lambda n: n.linalg.matrix_power(n.array(sq), 2),
               lambda n: n.linalg.multi_dot([n.array(_X), n.array(_Y.T),
                                             n.array(_X)]),
               lambda n: n.linalg.norm(n.array(_X)),
               lambda n: n.linalg.norm(n.array(_X), axis=1),
               lambda n: n.linalg.norm(n.array(_X), ord=1),
               lambda n: n.linalg.svd(n.array(a))[1],
               lambda n: n.linalg.lstsq(n.array(_c(5, 3)), n.array(_c(5)),
                                        rcond=None)):
        _both(fn, rtol=1e-3, atol=1e-3)
    u, s, vh = tnp.linalg.svd(tnp.array(a))
    golden((u.asnumpy() * s.asnumpy()) @ vh.asnumpy(), a, 1e-4, 1e-4)
    q, r = tnp.linalg.qr(tnp.array(a))
    golden(q.asnumpy() @ r.asnumpy(), a, 1e-4, 1e-4)
    golden(q.asnumpy().T @ q.asnumpy(), onp.eye(3), 1e-4, 1e-4)
    w, v = tnp.linalg.eigh(tnp.array(sq))
    golden(v.asnumpy() @ onp.diag(w.asnumpy()) @ v.asnumpy().T, sq,
           1e-4, 1e-4)


def test_np_random_by_properties():
    tnpx.seed(11)
    r = tnp.random
    u = r.uniform(size=(2000,))
    assert type(u).__name__ == "ndarray" and 0.4 < float(u.mean()) < 0.6
    assert abs(float(r.normal(2.0, 0.5, size=(2000,)).mean()) - 2.0) < 0.15
    assert r.randn(3, 2).shape == (3, 2) and r.rand(4).shape == (4,)
    assert r.normal().shape == ()
    ri = r.randint(3, 9, size=(500,))
    assert int(ri.min()) >= 3 and int(ri.max()) <= 8
    assert ri.dtype == onp.int32
    b = r.beta(2.0, 5.0, size=(2000,))
    assert 0.0 < float(b.min()) and float(b.max()) < 1.0
    assert abs(float(b.mean()) - 2.0 / 7.0) < 0.1
    assert abs(float(r.chisquare(3.0, size=(2000,)).mean()) - 3.0) < 0.5
    assert float(r.lognormal(0.0, 0.25, size=(2000,)).min()) > 0
    assert abs(float(r.laplace(1.0, 1.0, size=(3000,)).mean()) - 1.0) < 0.25
    assert abs(float(r.logistic(0.0, 1.0, size=(2000,)).mean())) < 0.3
    assert abs(float(r.gumbel(0.0, 1.0, size=(2000,)).mean()) - 0.5772) < 0.3
    assert float(r.pareto(3.0, size=(2000,)).min()) >= 0
    assert abs(float(r.rayleigh(1.0, size=(2000,)).mean())
               - onp.sqrt(onp.pi / 2)) < 0.2
    assert abs(float(r.weibull(1.0, size=(2000,)).mean()) - 1.0) < 0.2
    pw = r.power(2.0, size=(2000,))
    assert 0.0 <= float(pw.min()) and float(pw.max()) <= 1.0
    assert abs(float(r.exponential(0.5, size=(2000,)).mean()) - 0.5) < 0.1
    assert abs(float(r.gamma(2.0, 1.0, size=(2000,)).mean()) - 2.0) < 0.2
    assert abs(float(r.poisson(3.0, size=(2000,)).mean()) - 3.0) < 0.2
    ch = r.choice(5, size=(300,))
    assert int(ch.min()) >= 0 and int(ch.max()) <= 4
    chp = r.choice(3, size=(800,), p=[0.8, 0.1, 0.1])
    assert onp.bincount(chp.asnumpy().astype(int), minlength=3)[0] > 450
    picked = r.choice(tnp.arange(10), size=(10,), replace=False)
    assert sorted(picked.tolist()) == list(range(10))
    assert sorted(r.permutation(6).tolist()) == [0, 1, 2, 3, 4, 5]
    mn = r.multinomial(50, [0.5, 0.5], size=4)
    assert mn.shape == (4, 2) and (mn.asnumpy().sum(1) == 50).all()
    arr = tnp.arange(8)
    r.shuffle(arr)
    assert sorted(arr.tolist()) == list(range(8))
    tnpx.seed(5)
    a1 = r.uniform(size=(16,)).asnumpy()
    tnpx.seed(5)
    assert (r.uniform(size=(16,)).asnumpy() == a1).all()


# ---------------------------------------------------------------------------
# the ndarray type
# ---------------------------------------------------------------------------
def test_ndarray_semantics():
    x = tnp.array(_X)
    s = x.sum()
    assert s.shape == () and isinstance(float(s), float)
    assert f"{s:.3f}" == f"{float(_X.sum()):.3f}"
    m = x > 0
    assert m.dtype == onp.bool_ and type(m).__name__ == "ndarray"
    assert (x[m].asnumpy() == _X[_X > 0]).all()
    y = tnp.array(_X.copy())
    y[y > 0] = 0.0
    assert (y.asnumpy() <= 0).all()
    idx = tnp.array(onp.array([2, 0], onp.int32))
    assert (x[idx].asnumpy() == _X[[2, 0]]).all()
    for r in (x + 1, x @ tnp.array(_Y.T), -x, x.copy(), x.astype("float64"),
              x.detach(), x * x, torch.tanh(x), x[0], abs(x), x ** 2):
        assert type(r).__name__ == "ndarray"
    assert ((m & ~m).asnumpy() == False).all()  # noqa: E712
    assert ((m | ~m).asnumpy() == True).all()  # noqa: E712
    assert tnp.array(3.5).item() == pytest.approx(3.5)
    assert tnp.array([1.0, 2.0]).tolist() == [1.0, 2.0]
    z = tnp.array(onp.array([3.0, 1.0, 2.0], onp.float32))
    assert z.sort() is None and z.tolist() == [1.0, 2.0, 3.0]
    assert repr(tnp.array([1.0])).startswith("array(")
    # NumPy's dtype and size, while torch's code keeps calling size()
    assert x.dtype == onp.float32 and x.dtype == tnp.float32
    assert str(tnp.array(_I8).dtype) == "int32"
    assert x.size == 12 and isinstance(x.size, int)
    assert tuple(x.size()) == (3, 4) and x.size(1) == 4
    assert x.T.shape == (4, 3) and x.ndim == 2 and len(x) == 3
    assert x.reshape((0, -1)).shape == (3, 4)
    assert tnp.shape(x) == (3, 4) and tnp.size(x) == 12 and tnp.ndim(x) == 2
    assert tnp.result_type(tnp.array([1.0]), onp.float64) == onp.float64
    assert hash(x) == hash(x) and {x: 1}[x] == 1
    assert tnp.may_share_memory(x, x.reshape(-1))
    assert not tnp.may_share_memory(tnp.array([1.0]), tnp.array([2.0]))
    assert tnp.pi == onp.pi and tnp.newaxis is None
    assert tnp.float32 is onp.float32 and tnp.inf == onp.inf
    assert tnp.finfo("float32").eps == onp.finfo(onp.float32).eps
    low = tnp.array(_c(4, 4))[tnp.tril_indices(4)]
    assert low.shape == (10,)
    with pytest.raises(ValueError, match="one-dimensional"):
        tnp.vander(tnp.array(_X))
    with pytest.raises(ValueError):
        tnp.dsplit(tnp.array(_X), 2)


def test_pickle_round_trip_keeps_the_class():
    y = pickle.loads(pickle.dumps(tnp.array(_X)))
    assert type(y).__name__ == "ndarray" and (y.asnumpy() == _X).all()
    c = pickle.loads(pickle.dumps(tmx.nd.array(_X)))
    assert type(c).__name__ == "NDArray"


def test_interop_and_the_tape():
    x = tnp.array(_X)
    c = x.as_nd_ndarray()
    assert type(c).__name__ == "NDArray"
    assert type(c.as_np_ndarray()).__name__ == "ndarray"
    assert c.data_ptr() == x.data_ptr()           # one storage
    assert type(tmx.nd.relu(x)).__name__ == "ndarray"   # any-input rule
    assert type(tmx.nd.relu(c)).__name__ == "NDArray"
    # method-delegating functions give np arrays for classic inputs
    classic = tmx.nd.ones((2, 3))
    for fn in (lambda: tnp.transpose(classic), lambda: tnp.reshape(classic, 6),
               lambda: tnp.ravel(classic), lambda: tnp.copy(classic)):
        assert type(fn()).__name__ == "ndarray"
    src = tmx.nd.ones((2,))
    assert tnp.array(src).context == src.context
    # conversions under record stay on the tape, both ways
    grads = []
    for lib in (tmx, jmx):
        leaf = lib.np.array(_X)
        leaf.attach_grad()
        assert type(leaf.grad).__name__ == "ndarray"
        with lib.autograd.record():
            mid = leaf.as_nd_ndarray()
            y = lib.nd.square(mid).as_np_ndarray()
            loss = (y * lib.np.array(_Y)).sum()
        loss.backward()
        grads.append(leaf.grad.asnumpy())
    onp.testing.assert_allclose(grads[0], grads[1], rtol=1e-6, atol=1e-6)
    onp.testing.assert_allclose(grads[0], 2 * _X * _Y, rtol=1e-6, atol=1e-6)


def test_autograd_through_np_ops_matches_jax():
    a0, b0, z0 = _c(3, 4), _c(4, 2), _c(3)
    got = {}
    for lib in (tmx, jmx):
        a, b, a2 = lib.np.array(a0), lib.np.array(b0), lib.np.array(a0)
        sq = lib.np.array(_SQ)
        for v in (a, b, a2, sq):
            v.attach_grad()
        with lib.autograd.record():
            out = lib.np.einsum("ij,jk->ik", a, b).sum()
            z = lib.np.tensordot(a2, lib.np.array(_Y),
                                 axes=([0, 1], [0, 1]))
            sol = lib.np.linalg.solve(sq, lib.np.array(z0)).sum()
            total = out + z + sol
        total.backward()
        got[lib] = [v.grad.asnumpy() for v in (a, b, a2, sq)]
    for g, w in zip(got[tmx], got[jmx]):
        onp.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-5)
    onp.testing.assert_allclose(got[tmx][0], onp.ones((3, 2)) @ b0.T,
                                rtol=1e-5, atol=1e-5)
    # polyval and vander stay differentiable (registry ops only)
    xv = tnp.array([2.0])
    xv.attach_grad()
    with tmx.autograd.record():
        y = tnp.polyval(tnp.array([1.0, 0.0, -1.0]), xv) + \
            tnp.vander(xv, 3).sum()
    y.backward()
    assert float(xv.grad.asnumpy()[0]) == 4.0 + 2 * 2.0 + 1


# ---------------------------------------------------------------------------
# npx
# ---------------------------------------------------------------------------
def test_npx_operators_match_jax():
    w0, img, ker = _c(5, 4), _c(1, 2, 5, 5), _c(3, 2, 3, 3)
    cases = [
        lambda x, n: x.relu(n.array(_X)), lambda x, n: x.sigmoid(n.array(_X)),
        lambda x, n: x.softmax(n.array(_X), axis=-1),
        lambda x, n: x.log_softmax(n.array(_X), axis=-1),
        lambda x, n: x.fully_connected(n.array(_X), n.array(w0), None,
                                       num_hidden=5, no_bias=True),
        lambda x, n: x.one_hot(n.array(onp.array([0, 2], "int32")), depth=3),
        lambda x, n: x.pick(n.array(_X), n.array(onp.array([0, 1, 2],
                                                           "int32")), axis=1),
        lambda x, n: x.reshape(n.array(_c(2, 3, 4)), (-1, -2)),
        lambda x, n: x.reshape(n.array(_c(2, 3, 4)), (-3, -2)),
        lambda x, n: x.reshape(n.array(_c(2, 4, 3)), (0, -4, 2, 2, -2)),
        lambda x, n: x.embedding(n.array(onp.array([1, 0], "int32")),
                                 n.array(w0), input_dim=5, output_dim=4),
        lambda x, n: x.batch_dot(n.array(_c(2, 3, 4)), n.array(_c(2, 4, 2))),
        lambda x, n: x.convolution(n.array(img), n.array(ker), None,
                                   kernel=(3, 3), num_filter=3, no_bias=True),
        lambda x, n: x.gather_nd(n.array(_X), n.array(
            onp.array([[0, 1], [0, 2]], "int32"))),
        lambda x, n: x.layer_norm(n.array(_X), n.array(_P[0]),
                                  n.array(_c(4)), axis=-1, eps=1e-5),
        lambda x, n: x.topk(n.array(_X), k=2, ret_typ="value"),
        lambda x, n: x.gelu(n.array(_X)), lambda x, n: x.erf(n.array(_X)),
        lambda x, n: x.sequence_mask(n.array(_c(4, 2, 3)),
                                     n.array(onp.array([2, 3], "f")),
                                     use_sequence_length=True),
        lambda x, n: x.arange_like(n.array(_X)),
    ]
    for fn in cases:
        got = fn(tnpx, tnp)
        assert type(got).__name__ == "ndarray"
        same(got, fn(jnpx, jnp_), rtol=1e-4, atol=1e-4)
    with pytest.raises(NotImplementedError, match="Vision remainders"):
        tnpx.deconvolution(tnp.array(img), tnp.array(ker), None,
                           kernel=(3, 3), num_filter=2)
    assert set(jnpx.__all__) <= set(dir(tnpx))
    assert set(jnp_.__all__) <= set(dir(tnp))
    assert set(jnp_.linalg.__all__) <= set(dir(tnp.linalg))
    assert set(jnp_.random.__all__) <= set(dir(tnp.random))


def test_npx_rnn_matches_jax():
    t, n, h = 5, 2, 4
    x0 = _c(t, n, 3)
    nparam = 4 * h * (3 + h) + 8 * h
    p0 = (_c(nparam) * 0.3).astype("f")
    s0 = _c(1, n, h)
    c0 = _c(1, n, h)
    kw = dict(state_size=h, num_layers=1, mode="lstm", state_outputs=True)
    got = tnpx.rnn(tnp.array(x0), tnp.array(p0), tnp.array(s0),
                   tnp.array(c0), **kw)
    want = jnpx.rnn(jnp_.array(x0), jnp_.array(p0), jnp_.array(s0),
                    jnp_.array(c0), **kw)
    assert all(type(g).__name__ == "ndarray" for g in got)
    same(got, want, rtol=1e-4, atol=1e-5)


def test_npx_save_load_across_packages(tmp_path):
    f = str(tmp_path / "arrs.params")
    tnpx.save(f, {"a": tnp.array(_X), "b": tnp.array(_V)})
    for lib in (tnpx, jnpx):
        loaded = lib.load(f)
        assert type(loaded["a"]).__name__ == "ndarray"
        assert (loaded["a"].asnumpy() == _X).all()
        assert (loaded["b"].asnumpy() == _V).all()
    g = str(tmp_path / "jax.params")
    jnpx.save(g, [jnp_.array(_I8)])
    back = tnpx.load(g)
    assert type(back[0]).__name__ == "ndarray" and back[0].dtype == onp.int32
    assert (back[0].asnumpy() == _I8).all()
    tnpx.waitall()


# ---------------------------------------------------------------------------
# mx.sym.np / mx.sym.npx
# ---------------------------------------------------------------------------
def _run(lib, sym, **feeds):
    ex = sym.bind(lib.cpu(), {k: lib.nd.array(v, ctx=lib.cpu())
                              for k, v in feeds.items()})
    return [o.asnumpy() for o in ex.forward()]


def _sym_graphs(lib):
    s, v = lib.sym, lib.sym.var
    a, b = v("a"), v("b")
    graphs = [
        (s.np.einsum("ij,kj->ik", s.np.tanh(a), b), dict(a=_X, b=_Y)),
        (s.np.add(a, 2.5), dict(a=_X)),
        (s.np.sum(s.np.tril(a), axis=1), dict(a=_X)),
        (s.np.linalg.cholesky(a), dict(a=_SQ)),
        (s.npx.relu(a), dict(a=_X)),
        (s.np.left_shift(a, 2), dict(a=_I8)),
        (s.np.concatenate([a, b], axis=None), dict(a=_X, b=_Y)),
        (s.npx.reshape(a, (-1, -2)), dict(a=_X)),
        (s.Group([s.np.split(a, (1, 3), axis=1)[i] for i in range(3)]),
         dict(a=_c(2, 6))),
        (s.Group([s.np.array_split(a, 4, axis=1)[i] for i in range(4)]),
         dict(a=_c(2, 6))),
        (s.Group(list(s.np.meshgrid(a, b))), dict(a=_c(3), b=_c(4))),
        (s.np.vstack([a, b]), dict(a=_X, b=_Y)),
        (s.np.average(a, axis=0, weights=b), dict(a=_X, b=_P)),
        (s.np.quantile(a, 0.25), dict(a=_X)),
        (s.np.around(a, 1), dict(a=_X)),
        (s.np.atleast_3d(a), dict(a=_X)),
        (s.np.interp(a, b, v("c")), dict(a=_c(5), b=onp.sort(_c(8)),
                                         c=_c(8))),
    ]
    return graphs


def test_sym_np_graphs_match_jax_and_round_trip_json():
    for (ts, feeds), (js, _) in zip(_sym_graphs(tmx), _sym_graphs(jmx)):
        got = _run(tmx, ts, **feeds)
        want = _run(jmx, js, **feeds)
        assert len(got) == len(want)
        for g, w in zip(got, want):
            onp.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-4)
        again = _run(tmx, tmx.sym.load_json(ts.tojson()), **feeds)
        for g, w in zip(again, got):
            assert onp.array_equal(g, w)
    # an np-style block through the Symbol path
    class NpBlock(tmx.gluon.nn.HybridBlock):
        def hybrid_forward(self, F, x):
            return F.npx.relu(F.np.multiply(x, 2.0))

    blk = NpBlock()
    blk.initialize()
    out = _run(tmx, blk(tmx.sym.var("x")), x=_X)[0]
    golden(out, onp.maximum(_X * 2.0, 0))


def test_sym_np_raises_as_the_jax_package():
    for lib in (tmx, jmx):
        a = lib.sym.var("a")
        with pytest.raises(NotImplementedError, match="hybridize"):
            lib.sym.np.unique(a)
        with pytest.raises(NotImplementedError, match="dynamic"):
            lib.sym.np.argwhere(a)
        with pytest.raises(TypeError, match="Symbol or python scalar"):
            lib.sym.np.add(a, onp.ones(3))
        with pytest.raises(AttributeError, match="hybridize"):
            lib.sym.np.zeros((3,))
        assert getattr(lib.sym.npx, "save", None) is None
        with pytest.raises(TypeError, match="tensor argument"):
            lib.sym.np.dot(a)
        with pytest.raises(TypeError, match="keywords"):
            lib.sym.npx.fully_connected(a, 128, lib.sym.var("w"))
        with pytest.raises(TypeError, match="does not accept axis"):
            lib.sym.np.vsplit(a, 2, axis=1)
    assert set(jmx.sym.np.__all__) <= set(tmx.sym.np.__all__)
    assert set(jmx.sym.npx.__all__) <= set(tmx.sym.npx.__all__)
    with pytest.raises(NotImplementedError, match="Vision remainders"):
        tmx.sym.npx.roi_pooling(tmx.sym.var("a"), tmx.sym.var("r"))


def test_npi_registry_names_are_ported():
    from mxnet_tpu.ndarray import register as jreg
    from mxnet_tpu_torch.ndarray import register as treg
    jax_npi = {n for n in jreg._OPS if n.startswith("_npi_")}
    assert jax_npi <= set(treg._OPS)
    got = tmx.nd._npi_std(tmx.nd.array(_X), axis=1)
    onp.testing.assert_allclose(got.asnumpy(), onp.std(_X, axis=1),
                                rtol=1e-5, atol=1e-6)
