"""The port's single-process KVStore against the JAX package's, on the
CPU, with numpy-seeded inputs.

- ``init``/``push``/``pull``/``pushpull``/``broadcast`` with integer and
  string keys give the JAX store's values exactly (sums of a few
  float32 arrays in the same order).
- ``row_sparse_pull`` to a dense and to a row_sparse destination, as
  ``tests/test_kvstore.py:133`` and ``tests/test_io.py:402``: the JAX
  store's rows and ids exactly.
- A row_sparse push through each optimizer's updater (SGD, SGD with
  momentum, Adam, AdaGrad; string key ``"weight"``) agrees within 1e-6
  with the JAX store's (the same lazy row updates), and the rows not
  pushed keep their bits. Repeated row ids in one push add up (the
  reference's unique-row-id merge), held against numpy within 1e-6.
- ``Trainer(kvstore=<store>, update_on_kvstore=True)`` trains a small
  MLP as the JAX Trainer does: weights within 1e-5 after 3 momentum
  SGD steps (float32 GEMMs summed in another order).
"""
import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
from mxnet_tpu import autograd as jag
from mxnet_tpu import gluon as jgluon
from mxnet_tpu.ndarray import sparse as jsp
import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import autograd as ag
from mxnet_tpu_torch import gluon, nd
from mxnet_tpu_torch.ndarray import sparse as tsp

torch.set_num_threads(1)

TOL = 1e-6


def _both(fn):
    """``fn(mx, nd_array, sparse)`` run on each package (the port's on
    the CPU); returns (port, jax)."""
    want = fn(jmx, jmx.nd.array, jsp)
    with tmx.cpu():
        got = fn(tmx, nd.array, tsp)
    return got, want


@pytest.mark.parametrize("key", [3, "w"])
def test_init_push_pull_pushpull_broadcast_match_jax(key):
    rs = np.random.RandomState(0)
    a, b, c = (rs.randn(2, 3).astype(np.float32) for _ in range(3))

    def run(mx, arr, _sp):
        kv = mx.kv.create("local")
        kv.init(key, arr(a))
        out = arr(np.zeros((2, 3), np.float32))
        kv.pull(key, out=out)
        first = out.asnumpy()
        kv.push(key, [arr(b), arr(c)])          # two replicas: summed
        kv.pull(key, out=out)
        summed = out.asnumpy()
        val = arr(a)
        kv.pushpull(key, val)
        kv.broadcast(key + 1 if isinstance(key, int) else key + "2", arr(c),
                     out=out)
        return first, summed, val.asnumpy(), out.asnumpy()

    got, want = _both(run)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_store_identity_and_refusals():
    kv = tmx.kv.create("Device")
    assert (kv.type, kv.rank, kv.num_workers) == ("device", 0, 1)
    for name in ("local", "nccl", "local_allreduce_device"):
        assert tmx.kvstore.create(name).type == name
    for name in ("dist_sync", "dist_async", "dist_device_sync", "horovod"):
        with pytest.raises(NotImplementedError, match="'Multi-GPU'"):
            tmx.kv.create(name)
    with pytest.raises(tmx.MXNetError, match="unknown kvstore"):
        tmx.kv.create("nccl2")
    with pytest.raises(NotImplementedError, match="'Serving remainders'"):
        kv.expose()
    with tmx.cpu():
        kv.init(0, nd.zeros((2,)))
        with pytest.raises(tmx.MXNetError, match="already initialized"):
            kv.init(0, nd.zeros((2,)))
        with pytest.raises(tmx.MXNetError, match="not initialized"):
            kv.pull(1, out=nd.zeros((2,)))
    with pytest.raises(tmx.MXNetError, match="compression"):
        kv.set_gradient_compression({"type": "1bit"})
    # one replica: nothing to compress, the push is the plain sum
    kv.set_gradient_compression({"type": "2bit", "threshold": 0.5})
    with tmx.cpu():
        kv.push(0, [nd.array([0.3, -0.2]), nd.array([0.1, 0.0])])
        out = nd.zeros((2,))
        kv.pull(0, out=out)
    np.testing.assert_allclose(out.asnumpy(), [0.4, -0.2], rtol=1e-6)
    with pytest.raises(tmx.MXNetError, match="no optimizer"):
        kv.save_optimizer_states("unused")


def test_row_sparse_pull_dense_and_row_sparse_destinations_match_jax():
    """tests/test_kvstore.py:133: requested rows land in the
    destination, repeated ids once, the other rows zero."""
    table = np.arange(20, dtype=np.float32).reshape(10, 2)
    rid = np.array([7, 2, 2, 5], np.int64)

    def run(mx, arr, sp):
        kv = mx.kv.create("local")
        kv.init("emb", arr(table))
        dense = arr(np.zeros((10, 2), np.float32))
        kv.row_sparse_pull("emb", out=dense, row_ids=arr(rid))
        rsp = sp.row_sparse_array((np.zeros((1, 2), np.float32),
                                   np.array([0], np.int64)), shape=(10, 2))
        kv.row_sparse_pull("emb", out=rsp, row_ids=arr(rid))
        return dense.asnumpy(), rsp.indices.asnumpy(), rsp.data.asnumpy()

    got, want = _both(run)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(got[1], [2, 5, 7])


def test_sparse_push_pull_round_trip_matches_jax():
    """tests/test_io.py:402: a row_sparse push through the SGD updater
    moves only the pushed rows."""
    def run(mx, arr, sp):
        kv = mx.kv.create("local")
        kv.init("w", arr(np.ones((6, 3), np.float32)))
        kv.set_optimizer(mx.optimizer.SGD(learning_rate=0.5, wd=0.0,
                                          momentum=0.0))
        kv.push("w", sp.row_sparse_array(
            (np.full((2, 3), 2.0, np.float32), np.array([1, 4])),
            shape=(6, 3)))
        out = arr(np.zeros((6, 3), np.float32))
        kv.pull("w", out=out)
        return out.asnumpy()

    got, want = _both(run)
    np.testing.assert_array_equal(got, want)
    exp = np.ones((6, 3), np.float32)
    exp[[1, 4]] -= 1.0
    np.testing.assert_array_equal(got, exp)


OPTIMIZERS = [
    ("sgd", dict(learning_rate=0.5, wd=0.01)),
    ("sgd", dict(learning_rate=0.5, momentum=0.9, clip_gradient=0.3)),
    ("adam", dict(learning_rate=0.01, wd=0.01)),
    ("adagrad", dict(learning_rate=0.1, eps=1e-6)),
]


@pytest.mark.parametrize("name,kw", OPTIMIZERS)
def test_row_sparse_push_through_each_updater_matches_jax(name, kw):
    rs = np.random.RandomState(1)
    w0 = rs.randn(12, 4).astype(np.float32)
    pushes = [(rs.randn(3, 4).astype(np.float32), np.array(r, np.int64))
              for r in ([0, 5, 9], [5, 6, 11])]

    def run(mx, arr, sp):
        kv = mx.kv.create("local")
        kv.init("weight", arr(w0))
        kv.set_optimizer(mx.optimizer.create(name, **kw))
        for _ in range(2):
            for g, r in pushes:
                kv.push("weight", sp.row_sparse_array((g, r), shape=(12, 4)))
        out = arr(np.zeros((12, 4), np.float32))
        kv.pull("weight", out=out)
        return out.asnumpy()

    got, want = _both(run)
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
    untouched = [1, 2, 3, 4, 7, 8, 10]
    np.testing.assert_array_equal(got[untouched], w0[untouched])


def test_repeated_row_ids_in_one_push_add_up():
    rs = np.random.RandomState(2)
    w0 = rs.randn(6, 2).astype(np.float32)
    g = rs.randn(4, 2).astype(np.float32)
    rows = np.array([4, 1, 4, 1], np.int64)
    with tmx.cpu():
        kv = tmx.kv.create("local")
        kv.init(0, nd.array(w0))
        kv.set_optimizer(tmx.optimizer.SGD(learning_rate=0.1))
        kv.push(0, tsp.row_sparse_array((g, rows), shape=(6, 2)))
        out = nd.zeros((6, 2))
        kv.pull(0, out=out)
    want = w0.copy()
    np.add.at(want, rows, -0.1 * g)
    np.testing.assert_allclose(out.asnumpy(), want, rtol=TOL, atol=TOL)
    # two row_sparse replicas merge by unique id the same way
    with tmx.cpu():
        kv = tmx.kv.create("local")
        kv.init(0, nd.zeros((6, 2)))
        kv.push(0, [tsp.row_sparse_array((g[:2], rows[:2]), shape=(6, 2)),
                    tsp.row_sparse_array((g[2:], rows[2:]), shape=(6, 2))])
        kv.pull(0, out=out)
    want = np.zeros((6, 2), np.float32)
    np.add.at(want, rows, g)
    np.testing.assert_allclose(out.asnumpy(), want, rtol=TOL, atol=TOL)


def test_optimizer_states_save_and_load(tmp_path):
    w0 = np.random.RandomState(3).randn(5, 2).astype(np.float32)
    g = tsp.row_sparse_array((np.ones((2, 2), np.float32), [0, 3]),
                             shape=(5, 2), ctx="cpu")
    outs = []
    for reload in (False, True):
        with tmx.cpu():
            kv = tmx.kv.create("local")
            kv.init("weight", nd.array(w0))
            kv.set_optimizer(tmx.optimizer.Adam(learning_rate=0.1))
            kv.push("weight", g)
            if reload:
                path = str(tmp_path / "kv.states")
                kv.save_optimizer_states(path, dump_optimizer=True)
                kv.set_optimizer(tmx.optimizer.Adam(learning_rate=0.1))
                kv.load_optimizer_states(path)
            kv.push("weight", g)
            out = nd.zeros((5, 2))
            kv.pull("weight", out=out)
            outs.append(out.asnumpy())
    np.testing.assert_array_equal(outs[0], outs[1])


def _mlp(lib):
    net = lib.nn.HybridSequential()
    net.add(lib.nn.Dense(6, activation="relu", in_units=4),
            lib.nn.Dense(3, in_units=6))
    return net


def test_trainer_with_a_store_object_and_update_on_kvstore_matches_jax():
    rs = np.random.RandomState(4)
    x = rs.randn(8, 4).astype(np.float32)
    y = rs.randint(0, 3, 8).astype(np.float32)
    jnet = _mlp(jgluon)
    jnet.initialize(init=jmx.initializer.Xavier())
    jtr = jgluon.Trainer(jnet.collect_params(), "sgd",
                         {"learning_rate": 0.1, "momentum": 0.9},
                         kvstore=jmx.kv.create("local"),
                         update_on_kvstore=True)
    jloss = jgluon.loss.SoftmaxCrossEntropyLoss()
    with tmx.cpu():
        tnet = _mlp(gluon)
        tnet.initialize()
    for (k, p), (_, jp) in zip(tnet.collect_params().items(),
                               jnet.collect_params().items()):
        p.set_data(jp.data().asnumpy())
    kv = tmx.kv.create("local")
    ttr = gluon.Trainer(tnet.collect_params(), "sgd",
                        {"learning_rate": 0.1, "momentum": 0.9}, kvstore=kv,
                        update_on_kvstore=True)
    tloss = gluon.loss.SoftmaxCrossEntropyLoss()
    for _ in range(3):
        with jag.record():
            jl = jloss(jnet(jmx.nd.array(x)), jmx.nd.array(y))
        jl.backward()
        jtr.step(8)
        with ag.record():
            tl = tloss(tnet(nd.array(x, ctx="cpu")), nd.array(y, ctx="cpu"))
        tl.backward()
        ttr.step(8)
    assert ttr._kvstore is kv and ttr._update_on_kvstore
    for (k, p), (_, jp) in zip(tnet.collect_params().items(),
                               jnet.collect_params().items()):
        np.testing.assert_allclose(p.data().asnumpy(), jp.data().asnumpy(),
                                   rtol=1e-5, atol=1e-5, err_msg=k)
    with pytest.raises(AssertionError, match="update_on_kvstore"):
        ttr.allreduce_grads()
    with pytest.raises(AssertionError, match="update_on_kvstore"):
        ttr.update(8)
    # the store holds the momentum states
    assert set(kv._updater.states) == {0, 1, 2, 3}


def test_trainer_row_sparse_pull_reads_the_weight_rows():
    with tmx.cpu():
        net = gluon.nn.Embedding(6, 2, sparse_grad=True)
        net.initialize()
        p = net.collect_params()["weight"]
        rsp = tsp.zeros("row_sparse", (6, 2))
        ids = nd.array(np.array([4, 1, 4], np.int64))
        for update_on_kvstore in (False, True):
            tr = gluon.Trainer([p], "sgd", {"learning_rate": 0.1},
                               update_on_kvstore=update_on_kvstore)
            tr._row_sparse_pull(p, rsp, ids)
            np.testing.assert_array_equal(rsp.indices.asnumpy(), [1, 4])
            np.testing.assert_array_equal(rsp.data.asnumpy(),
                                          p.data().asnumpy()[[1, 4]])
    assert p.grad_stype == "row_sparse"
    assert p.row_sparse_data(None).stype == "row_sparse"
