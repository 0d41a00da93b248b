"""The port's runtime modules against the JAX package's on the CPU:
``random`` (seeding), ``engine`` (``wait_all``, bulk size), ``name``,
``attribute``, ``util`` (the np flags), ``test_utils`` and ``runtime``
(``mx.runtime.Features``)."""
import os

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx
from mxnet_tpu import attribute as jattr
from mxnet_tpu import engine as jengine
from mxnet_tpu import name as jname
from mxnet_tpu import test_utils as jtu
from mxnet_tpu import util as jutil
from mxnet_tpu_torch import attribute, engine, name, nd, test_utils, util

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _np_mode_off():
    """The numpy flags are process-wide in both packages (and the port's
    wrap reads them): each test leaves them off."""
    yield
    util.reset_np()
    jutil.reset_np()
    assert not util.is_np_array() and not util.is_np_shape()
    assert not jutil.is_np_array() and not jutil.is_np_shape()


def test_seed_repeats_draws_per_device():
    with tmx.cpu():
        tmx.random.seed(42)
        a = nd.random.uniform(shape=(5,)).asnumpy()
        tmx.random.seed(42, ctx=tmx.cpu())
        b = nd.random.uniform(shape=(5,)).asnumpy()
        c = nd.random.normal(shape=(5,)).asnumpy()
        state = tmx.random.get_state()
        d = nd.random.normal(shape=(5,)).asnumpy()
        tmx.random.generator().set_state(state)
        e = nd.random.normal(shape=(5,)).asnumpy()
    np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(d, e)
    assert not np.array_equal(c, d)
    # the Dropout op and the JAX package's seed API take the same calls
    jmx.random.seed(42)
    with tmx.cpu():
        tmx.random.seed(1)
        x = nd.ones((1000,))
        m1 = nd.Dropout(x, p=0.5, mode="always").asnumpy()
        tmx.random.seed(1)
        m2 = nd.Dropout(x, p=0.5, mode="always").asnumpy()
    np.testing.assert_array_equal(m1, m2)


def test_engine_matches_jax():
    engine.set_bulk_size(8)
    jengine.set_bulk_size(8)
    prev_t, prev_j = engine.set_bulk_size(4), jengine.set_bulk_size(4)
    assert prev_t == prev_j == 8
    with engine.bulk(16), jengine.bulk(16):
        assert engine.set_bulk_size(16) == jengine.set_bulk_size(16) == 16
    assert engine.set_bulk_size(15) == jengine.set_bulk_size(15) == 4
    engine.engine.wait_all()          # nothing to wait for on the CPU
    nd.waitall()
    with tmx.cpu():
        engine.engine.wait_for_var(nd.ones((2,)))
    assert isinstance(engine.engine, engine.Engine)


def test_name_manager_and_prefix_match_jax():
    for mod in (name, jname):
        with mod.NameManager():
            pass
    t, j = name.NameManager(), jname.NameManager()
    got = [t.get(None, "dense"), t.get(None, "dense"), t.get("x", "dense"),
           t.get(None, "conv")]
    want = [j.get(None, "dense"), j.get(None, "dense"), j.get("x", "dense"),
            j.get(None, "conv")]
    assert got == want == ["dense0", "dense1", "x", "conv0"]
    with name.Prefix("net_") as p, jname.Prefix("net_") as q:
        assert name.NameManager.current() is p
        assert p.get(None, "fc") == q.get(None, "fc") == "net_fc0"


def test_attr_scope_matches_jax():
    out = []
    for mod in (attribute, jattr):
        with mod.AttrScope(ctx_group="a", x=1):
            with mod.AttrScope(y="2"):
                out.append((mod.current().get({"z": "3"}),
                            mod.AttrScope.current().get()))
        out.append(mod.current().get())
    assert out[:2] == out[2:]
    assert out[0][0] == {"ctx_group": "a", "x": "1", "y": "2", "z": "3"}


def test_util_np_flags_match_jax(tmp_path):
    for mod in (util, jutil):
        assert not mod.is_np_array() and not mod.is_np_shape()
        with mod.np_scope():
            assert mod.is_np_array() and mod.is_np_shape()
        assert not mod.is_np_array()

        @mod.use_np
        def f():
            return mod.is_np_array(), mod.is_np_shape()

        assert f() == (True, True)
        mod.set_np(shape=True, array=False)
        assert (mod.is_np_array(), mod.is_np_shape()) == (False, True)
        mod.reset_np()
        d = tmp_path / mod.__name__ / "a" / "b"
        mod.makedirs(str(d))
        mod.makedirs(str(d))
        assert d.is_dir()
    os.environ["MXNET_PORT_TEST_ENV"] = "7"
    try:
        assert util.getenv("MXNET_PORT_TEST_ENV") == \
            jutil.getenv("MXNET_PORT_TEST_ENV") == "7"
    finally:
        del os.environ["MXNET_PORT_TEST_ENV"]
    assert util.getenv("MXNET_PORT_TEST_UNSET", "d") == "d"


def test_test_utils_match_jax():
    a = np.array([1.0, 2.0, 3.0], np.float32)
    b = a + np.float32(5e-5)
    with tmx.cpu():
        ta, tb = nd.array(a), nd.array(b)
        assert test_utils.same(ta, a) == jtu.same(jmx.nd.array(a), a)
        for args in ((ta, tb), (ta, tb, 1e-6, 1e-7), (ta, a + 1e-3)):
            jargs = [jmx.nd.array(x.asnumpy()) if hasattr(x, "asnumpy")
                     else x for x in args]
            assert test_utils.almost_equal(*args) == \
                jtu.almost_equal(*jargs)
        test_utils.assert_almost_equal(ta, tb)
        with pytest.raises(AssertionError, match="max abs err"):
            test_utils.assert_almost_equal(ta, a + 1e-2)
        h = nd.array(a).astype("float16")
        test_utils.assert_almost_equal(h, a + 5e-4)      # float16 tolerance
        assert test_utils.device_tols("bfloat16") == (3e-2, 1e-3)
        np.random.seed(0)
        s1 = test_utils.rand_shape_nd(3, 4)
        np.random.seed(0)
        assert s1 == jtu.rand_shape_nd(3, 4)
        r = test_utils.rand_ndarray((2, 3))
        assert isinstance(r, nd.NDArray) and r.shape == (2, 3)
        assert test_utils.list_gpus() == list(range(tmx.num_gpus()))
        out = test_utils.simple_forward(lambda x, y: x * y, a, a)
        np.testing.assert_allclose(out, a * a)
        test_utils.check_numeric_gradient(
            lambda x: nd.tanh(x) * x, [np.random.RandomState(1).uniform(
                -1, 1, (2, 3))])
        test_utils.check_consistency(
            lambda x: nd.softmax(x) * 3,
            [{"ctx": tmx.cpu(), "dtype": "float64"},
             {"ctx": tmx.cpu(), "dtype": "float32"}],
            [np.random.RandomState(2).uniform(-1, 1, (2, 4))])
        assert test_utils.default_context() == tmx.cpu()
        test_utils.set_default_context(tmx.cpu(0))
        assert test_utils.default_context() == tmx.cpu(0)
        test_utils.set_default_context(None)

    @test_utils.with_seed(3)
    def draw():
        with tmx.cpu():
            return np.random.rand(), nd.random.uniform(shape=(2,)).asnumpy()

    a1, b1 = draw()
    a2, b2 = draw()
    assert a1 == a2
    np.testing.assert_array_equal(b1, b2)
    with pytest.raises(NotImplementedError):
        test_utils.download("http://localhost/x")


@pytest.mark.parametrize("stype,shape,density", [
    ("default", (4, 3), None), ("row_sparse", (6, 3), 0.5),
    ("row_sparse", (5, 2, 2), None), ("csr", (6, 4), 0.5),
    ("csr", (3, 5), None)])
def test_rand_ndarray_takes_sparse_stypes_as_jax(stype, shape, density):
    """``rand_ndarray(stype=...)`` casts the uniform draw to ``stype``
    after zeroing the rows of the ``density`` mask, as the JAX
    function does: the same numpy seed gives the same dense values and
    the same storage type (exact)."""
    np.random.seed(3)
    want = jtu.rand_ndarray(shape, stype=stype, density=density)
    np.random.seed(3)
    with tmx.cpu():
        got = test_utils.rand_ndarray(shape, stype=stype, density=density)
    assert got.stype == want.stype == stype
    assert got.shape == tuple(want.shape)
    np.testing.assert_array_equal(got.asnumpy(), want.asnumpy())


def test_runtime_features_keep_the_jax_keys():
    """The twelve keys of the JAX package's ``Features``; the port
    detects through torch: ``CUDA``/``CUDNN`` from ``torch.cuda`` and
    ``torch.backends.cudnn`` (none here), no TPU, XLA, Pallas or dist
    kvstore; the other keys keep the JAX package's values."""
    from mxnet_tpu import runtime as jruntime

    want, got = jruntime.Features(), tmx.runtime.Features()
    assert list(got) == list(want)
    assert [f.name for f in tmx.runtime.feature_list()] == list(want)
    ours = {"TPU": False, "CUDA": torch.cuda.is_available(),
            "CUDNN": torch.cuda.is_available()
            and torch.backends.cudnn.is_available(),
            "XLA": False, "PALLAS": False, "DIST_KVSTORE": False}
    for k in want:
        assert got.is_enabled(k) == ours.get(k, want.is_enabled(k)), k
    assert repr(got["F16C"]) == repr(want["F16C"])
