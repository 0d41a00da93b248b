"""The reference's Block, Trainer, autograd, layer and DataLoader
arguments on the port, each held against the same JAX call on the CPU.

- ``Block.initialize(init, ctx, verbose, force_reinit)``: the same
  values, the same skip of initialized parameters without
  ``force_reinit``; a ``ctx`` list of two devices raises ``ValueError``.
- ``collect_params(select)``: the same names as the JAX regex select.
- ``Block(prefix, params)`` and ``ParameterDict(prefix, shared)``:
  parameters shared, also in children made in the name scope; the
  names of children made in ``name_scope()`` are the JAX names
  without the model prefix.
- ``Trainer.step/update(batch_size, ignore_stale_grad)`` and
  ``autograd.backward/grad(..., train_mode)``: the same weights and
  gradients as the JAX calls (1e-6).
- ``Dense(weight_initializer, bias_initializer)``, ``LayerNorm(center,
  scale, beta_initializer, gamma_initializer)``, the ``BatchNorm`` and
  ``Embedding`` initializers: the JAX layers' values and outputs
  (1e-6).
- ``Dropout(rate, axes)``: the mask is shared along ``axes`` and keeps
  about 1 - rate, as the JAX layer's (the bits differ: the generators
  differ by design).
- ``DataLoader(pin_memory, pin_device_id, timeout)``: the JAX loader's
  batches; ``pin_device_id=1`` raises ``ValueError``.
- Deferred ``Dense``, ``LSTM``, ``Conv2D``, ``BatchNorm`` and
  ``LayerNorm`` reach the JAX deferred layers' shapes; a deferred
  parameter read too early raises ``DeferredInitializationError``.
"""
import numpy as np
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu import autograd as jag
from mxnet_tpu import gluon as jgluon
from mxnet_tpu.gluon import nn as jnn
import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import autograd as ag
from mxnet_tpu_torch import gluon, initializer, nd
from mxnet_tpu_torch.gluon import nn, rnn
from mxnet_tpu_torch.gluon.parameter import (DeferredInitializationError,
                                             ParameterDict)

torch.set_num_threads(1)


def _jvals(block):
    return {k[len(block.prefix):]: v.data().asnumpy()
            for k, v in block.collect_params().items()}


def _tvals(block):
    return {k: v.data().asnumpy() for k, v in block.collect_params().items()}


def _mlp(lib, **kw):
    net = lib.HybridSequential(**kw)
    with net.name_scope():
        net.add(lib.Dense(4, activation="relu", in_units=3),
                lib.Dense(2, in_units=4))
    return net


def test_initialize_init_ctx_verbose_force_reinit():
    jnet, tnet = _mlp(jnn), None
    with tmx.cpu():
        tnet = _mlp(nn)
    jnet.initialize(mx.init.Constant(0.5), ctx=mx.cpu(), verbose=True)
    tnet.initialize(initializer.Constant(0.5), ctx=tmx.cpu(), verbose=True)
    assert _jvals(jnet).keys() == _tvals(tnet).keys()
    for k, v in _jvals(jnet).items():
        np.testing.assert_array_equal(_tvals(tnet)[k], v)
    # initialized parameters are kept unless force_reinit
    jnet.initialize(mx.init.Constant(2.0))
    with pytest.warns(UserWarning, match="already initialized"):
        tnet.initialize(initializer.Constant(2.0))
    np.testing.assert_array_equal(_tvals(tnet)["dense0_weight"],
                                  _jvals(jnet)["dense0_weight"])
    jnet.initialize(mx.init.Constant(2.0), force_reinit=True)
    tnet.initialize(initializer.Constant(2.0), force_reinit=True)
    for k, v in _jvals(jnet).items():
        np.testing.assert_array_equal(_tvals(tnet)[k], v)
    with pytest.raises(ValueError, match=r"cpu\(1\)"):
        tnet.initialize(ctx=[tmx.cpu(0), tmx.cpu(1)], force_reinit=True)


def test_collect_params_select():
    jnet = _mlp(jnn)
    with tmx.cpu():
        tnet = _mlp(nn)
    for select in (".*weight", ".*dense1_.*", "dense0_bias"):
        want = sorted(k[len(jnet.prefix):]
                      for k in jnet.collect_params(".*" + select).keys())
        got = sorted(tnet.collect_params(select).keys())
        assert got == want, select


def _children(block, lib):
    with block.name_scope():
        block.embed = lib.Embedding(10, 4)
        block.drop = lib.Dropout(0.1)
        block.dense = lib.Dense(3, flatten=False, in_units=4)
        block.dense2 = lib.Dense(3, flatten=False, in_units=3)


def test_name_scope_names_match_jax():
    class Net(jgluon.Block):
        def __init__(self, lib, **kw):
            super().__init__(**kw)
            _children(self, lib)

    class TNet(gluon.Block):
        def __init__(self, lib, **kw):
            super().__init__(**kw)
            _children(self, lib)

    jnet = Net(jnn)
    with tmx.cpu():
        tnet = TNet(nn)
    assert [k[len(jnet.prefix):] for k in jnet.collect_params()] == \
        list(tnet.gluon_params())
    assert tnet.prefix.startswith("tnet") and tnet.name == tnet.prefix[:-1]


def test_block_params_sharing_and_shared_parameter_dict():
    jd1 = jnn.Dense(3, in_units=4)
    jd2 = jnn.Dense(3, in_units=4, params=jd1.collect_params())
    with tmx.cpu():
        d1 = nn.Dense(3, in_units=4)
        d2 = nn.Dense(3, in_units=4, params=d1.collect_params())
    assert jd2.weight is jd1.weight
    assert d2.weight is d1.weight and d2.bias is d1.bias
    # a whole model: children made in the name scope share by name
    jn1 = _mlp(jnn)
    jn2 = _mlp(jnn, params=jn1.collect_params())
    with tmx.cpu():
        n1 = _mlp(nn)
        n2 = _mlp(nn, params=n1.collect_params())
    assert jn2[0].weight is jn1[0].weight
    for (k1, p1), (k2, p2) in zip(n1.gluon_params().items(),
                                  n2.gluon_params().items()):
        assert k1 == k2 and p1 is p2
    n1.initialize(seed=1)
    x = torch.randn(2, 3)
    torch.testing.assert_close(n1(x), n2(x), rtol=0, atol=0)
    # ParameterDict(prefix, shared): get hands out the shared parameter
    jshared = jgluon.ParameterDict("m_", shared=jd1.collect_params())
    assert jshared.get("weight") is not None
    shared = ParameterDict("m_", shared=d1.collect_params())
    assert shared.get("weight") is d1.collect_params()["weight"]
    assert "weight" in shared and shared.prefix == "m_"
    fresh = shared.get("extra", shape=(2, 0), ctx="cpu")
    assert fresh.shape == (2, 0)
    with pytest.raises(DeferredInitializationError):
        fresh.data()


def _trained(lib, ag_mod, jax_side, ignore):
    net = lib.Dense(2, in_units=3)
    if jax_side:
        net.initialize(mx.init.Constant(0.1))
        trainer = jgluon.Trainer(net.collect_params(), "sgd",
                                 {"learning_rate": 0.5})
        x = mx.nd.array(np.arange(6, dtype=np.float32).reshape(2, 3))
    else:
        net.initialize(initializer.Constant(0.1))
        trainer = gluon.Trainer(net.collect_params(), "sgd",
                                {"learning_rate": 0.5})
        x = nd.array(np.arange(6, dtype=np.float32).reshape(2, 3),
                     ctx="cpu")
    for step in range(2):
        with ag_mod.record():
            loss = (net(x) ** 2).sum()
        loss.backward()
        if step == 0:
            trainer.step(2, ignore_stale_grad=ignore)
        else:
            trainer.allreduce_grads()
            trainer.update(2, ignore_stale_grad=ignore)
    weight = next(iter(net.collect_params().values()))
    return weight.data().asnumpy()


@pytest.mark.parametrize("ignore", [False, True])
def test_trainer_step_update_ignore_stale_grad(ignore):
    want = _trained(jnn, jag, True, ignore)
    with tmx.cpu():
        got = _trained(nn, ag, False, ignore)
    np.testing.assert_allclose(got, want, rtol=1e-6)


@pytest.mark.parametrize("train_mode", [True, False])
def test_autograd_backward_and_grad_train_mode(train_mode):
    x = np.random.RandomState(5).randn(4).astype(np.float32)
    jx = mx.nd.array(x)
    jx.attach_grad()
    with jag.record():
        jy = jx * jx
    jag.backward([jy], train_mode=train_mode)
    with jag.record():
        jz = (jx * 3).sum()
    jg = jag.grad(jz, [jx], train_mode=train_mode)[0]
    tx = nd.array(x, ctx="cpu")
    tx.attach_grad()
    with ag.record():
        ty = tx * tx
    ag.backward([ty], train_mode=train_mode)
    with ag.record():
        tz = (tx * 3).sum()
    tg = ag.grad(tz, [tx], train_mode=train_mode)[0]
    np.testing.assert_allclose(tx.grad.asnumpy(), jx.grad.asnumpy(),
                               rtol=1e-6)
    np.testing.assert_allclose(tg.detach().numpy(), jg.asnumpy(), rtol=1e-6)
    assert not ag.is_training()


def test_dense_and_embedding_initializers():
    jd = jnn.Dense(3, in_units=2, weight_initializer=mx.init.Constant(0.25),
                   bias_initializer=mx.init.Constant(-1.0))
    je = jnn.Embedding(5, 2, weight_initializer=mx.init.Constant(3.0))
    for b in (jd, je):
        b.initialize(mx.init.Xavier())
    with tmx.cpu():
        td = nn.Dense(3, in_units=2,
                      weight_initializer=initializer.Constant(0.25),
                      bias_initializer=initializer.Constant(-1.0))
        te = nn.Embedding(5, 2, weight_initializer=initializer.Constant(3.0))
    for b in (td, te):
        b.initialize(initializer.Xavier())
    for j, t in ((jd, td), (je, te)):
        for k, v in _jvals(j).items():
            np.testing.assert_array_equal(_tvals(t)[k], v)
    # sparse_grad=True: the JAX layer's meaning (a row_sparse grad_stype
    # recorded, the gradient dense)
    sparse = nn.Embedding(5, 2, sparse_grad=True, device="cpu")
    jsparse = jnn.Embedding(5, 2, sparse_grad=True)
    assert sparse.collect_params()["weight"].grad_stype == "row_sparse" \
        == jsparse.weight._grad_stype


@pytest.mark.parametrize("center,scale", [(True, True), (False, True),
                                          (True, False), (False, False)])
def test_layer_norm_center_scale_initializers(center, scale):
    x = np.random.RandomState(6).randn(3, 5).astype(np.float32)
    kw = dict(center=center, scale=scale, in_channels=5)
    jln = jnn.LayerNorm(beta_initializer=mx.init.Constant(0.5),
                        gamma_initializer=mx.init.Constant(2.0), **kw)
    jln.initialize()
    tln = nn.LayerNorm(beta_initializer=initializer.Constant(0.5),
                       gamma_initializer=initializer.Constant(2.0),
                       device="cpu", **kw)
    tln.initialize()
    for k, v in _jvals(jln).items():
        np.testing.assert_array_equal(_tvals(tln)[k], v)
    reqs = {k[len(jln.prefix):]: p.grad_req
            for k, p in jln.collect_params().items()}
    assert {k: p.grad_req for k, p in tln.collect_params().items()} == reqs
    np.testing.assert_allclose(tln(torch.from_numpy(x)).numpy(),
                               jln(mx.nd.array(x)).asnumpy(), rtol=1e-5,
                               atol=1e-6)


def test_batch_norm_initializers():
    kw = dict(in_channels=3)
    jbn = jnn.BatchNorm(beta_initializer=mx.init.Constant(0.1),
                        gamma_initializer=mx.init.Constant(1.5),
                        running_mean_initializer=mx.init.Constant(0.2),
                        running_variance_initializer=mx.init.Constant(4.0),
                        **kw)
    jbn.initialize()
    tbn = nn.BatchNorm(beta_initializer=initializer.Constant(0.1),
                       gamma_initializer=initializer.Constant(1.5),
                       running_mean_initializer=initializer.Constant(0.2),
                       running_variance_initializer=initializer.Constant(4.0),
                       device="cpu", **kw)
    tbn.initialize()
    for k, v in _jvals(jbn).items():
        np.testing.assert_array_equal(_tvals(tbn)[k], v)
    x = np.random.RandomState(7).randn(2, 3, 4).astype(np.float32)
    np.testing.assert_allclose(tbn(torch.from_numpy(x)).numpy(),
                               jbn(mx.nd.array(x)).asnumpy(), rtol=1e-5,
                               atol=1e-6)


def _mask_stats(out, x, axes):
    kept = out != 0
    for a in axes:                       # one draw along each axis
        assert (kept == kept.take([0], axis=a)).all()
    frac = kept.mean()
    scale = out[kept] / x[kept]
    return frac, scale


@pytest.mark.parametrize("axes", [(1,), (0, 2)])
def test_dropout_axes_share_the_mask(axes):
    rate = 0.3
    x = np.random.RandomState(8).rand(64, 32, 16).astype(np.float32) + 1.0
    jd = jnn.Dropout(rate, axes=axes)
    with jag.record():
        jout = jd(mx.nd.array(x)).asnumpy()
    td = nn.Dropout(rate, axes=axes)
    with ag.record():
        tout = td(torch.from_numpy(x)).numpy()
    jfrac, jscale = _mask_stats(jout, x, axes)
    tfrac, tscale = _mask_stats(tout, x, axes)
    n = x.size / np.prod([x.shape[a] for a in axes])
    tol = 4 * np.sqrt(rate * (1 - rate) / n)
    assert abs(tfrac - (1 - rate)) < tol and abs(jfrac - (1 - rate)) < tol
    np.testing.assert_allclose(tscale, 1 / (1 - rate), rtol=1e-6)
    np.testing.assert_allclose(jscale, 1 / (1 - rate), rtol=1e-6)
    with ag.predict_mode():
        np.testing.assert_array_equal(td(torch.from_numpy(x)).numpy(), x)


def test_dataloader_pin_memory_device_id_timeout():
    x = np.arange(40, dtype=np.float32).reshape(10, 4)
    y = np.arange(10, dtype=np.float32)
    kw = dict(batch_size=4, pin_memory=True, pin_device_id=0, timeout=30)
    jb = list(jgluon.data.DataLoader(jgluon.data.ArrayDataset(x, y), **kw))
    for workers in (0, 2):
        tb = list(gluon.data.DataLoader(
            gluon.data.ArrayDataset(x, y), num_workers=workers,
            thread_pool=True, device="cpu", **kw))
        assert len(tb) == len(jb)
        for (tx, ty), (jx, jy) in zip(tb, jb):
            assert isinstance(tx, nd.NDArray)
            np.testing.assert_array_equal(tx.asnumpy(), jx.asnumpy())
            np.testing.assert_array_equal(ty.asnumpy(), jy.asnumpy())
    with pytest.raises(ValueError, match="pin_device_id 1"):
        gluon.data.DataLoader(gluon.data.ArrayDataset(x, y), batch_size=2,
                              pin_device_id=1, device="cpu")


def _deferred_pairs():
    return [
        (lambda: jnn.Dense(5), lambda: nn.Dense(5, device="cpu"),
         (2, 3, 4)),
        (lambda: jnn.Dense(5, flatten=False),
         lambda: nn.Dense(5, flatten=False, device="cpu"), (2, 3, 4)),
        (lambda: jnn.Conv2D(6, 3, padding=1),
         lambda: nn.Conv2D(6, 3, padding=1, device="cpu"), (2, 4, 5, 5)),
        (lambda: jnn.BatchNorm(), lambda: nn.BatchNorm(device="cpu"),
         (2, 3, 4)),
        (lambda: jnn.LayerNorm(), lambda: nn.LayerNorm(device="cpu"),
         (2, 7)),
        (lambda: jgluon.rnn.LSTM(6, num_layers=2, bidirectional=True),
         lambda: rnn.LSTM(6, num_layers=2, bidirectional=True,
                          device="cpu"), (3, 2, 5)),
    ]


@pytest.mark.parametrize("case", range(6))
def test_deferred_shapes_reach_the_jax_shapes(case):
    jmake, tmake, shape = _deferred_pairs()[case]
    x = np.random.RandomState(case).randn(*shape).astype(np.float32)
    jb, tb = jmake(), tmake()
    jb.initialize()
    jb(mx.nd.array(x))
    with pytest.raises(DeferredInitializationError):
        next(iter(tb.collect_params().values())).data() \
            if case != 5 else tb.collect_params()["l0_i2h_weight"].data()
    trainer = gluon.Trainer(tb.collect_params(), "sgd")
    tb.initialize(seed=3)
    with ag.record():
        out = tb(torch.from_numpy(x))
    out.sum().backward()
    want = {k[len(jb.prefix):]: v.shape
            for k, v in jb.collect_params().items()}
    assert {k: p.shape for k, p in tb.collect_params().items()} == want
    trainer.step(1)                      # the Trainer made before holds them
    assert all(torch.isfinite(p.data()).all()
               for p in tb.collect_params().values())


def test_deferred_seed_mapping_and_forward_before_initialize():
    a = nn.Dense(4, device="cpu")
    b = nn.Dense(4, device="cpu")
    a.initialize(seed=7)
    b.initialize(seed=7)
    x = torch.randn(2, 3)
    a(x)
    b(x)
    torch.testing.assert_close(a.weight, b.weight, rtol=0, atol=0)
    w = a.weight.detach().numpy()
    want = np.random.default_rng((7, 0)).standard_normal(
        (4, 3), dtype=np.float32) * np.float32(0.02)
    np.testing.assert_array_equal(w, want)
    c = nn.Dense(4, device="cpu")
    with pytest.raises(tmx.MXNetError, match="initialize"):
        c(x)
