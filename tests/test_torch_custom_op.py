"""The port's custom ops (``mx.operator``, ``nd.Custom``, ``sym.Custom``)
and ``autograd.Function`` against the JAX package's, on the CPU.

The same props are registered in both packages (a factory builds each
class over a package's ``mx``/``nd``), fed the same numpy-seeded
inputs, and their outputs and gradients compared within 1e-6 (float32:
the user's callbacks compose a handful of elementwise ops and a
softmax). The cases mirror tests/test_custom_op.py: registration,
eager forward and backward through the user's backward, params
reaching the prop, the softmax-loss gradient, a Gluon loop, a
hybridized block, ``sym.Custom`` with ``Module.fit`` and
``infer_shape``, several outputs and the errors.
"""
import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx
from mxnet_tpu import autograd as jag
from mxnet_tpu import nd as jnd
from mxnet_tpu_torch import autograd as tag
from mxnet_tpu_torch import nd as tnd

torch.set_num_threads(1)

TOL = dict(rtol=1e-6, atol=1e-6)


def _props(mx, nd):
    """Register the test props in one package; returns their names."""

    @mx.operator.register("tt_sqr")
    class SqrProp(mx.operator.CustomOpProp):
        """y = x^2 with a backward 2.5x the true gradient: matching it
        shows the user's backward ran, not autodiff."""

        def __init__(self, scale="2.5"):
            super().__init__(need_top_grad=True)
            self.scale = float(scale)

        def create_operator(self, ctx, in_shapes, in_dtypes):
            prop = self

            class Sqr(mx.operator.CustomOp):
                def forward(self, is_train, req, in_data, out_data, aux):
                    self.assign(out_data[0], req[0],
                                in_data[0] * in_data[0])

                def backward(self, req, out_grad, in_data, out_data,
                             in_grad, aux):
                    self.assign(in_grad[0], req[0],
                                prop.scale * out_grad[0] * in_data[0])

            return Sqr()

    @mx.operator.register("tt_softmax_loss")
    class SoftmaxLossProp(mx.operator.CustomOpProp):
        def __init__(self):
            super().__init__(need_top_grad=False)

        def list_arguments(self):
            return ["data", "label"]

        def infer_shape(self, in_shape):
            return [in_shape[0], [in_shape[0][0]]], [in_shape[0]], []

        def create_operator(self, ctx, in_shapes, in_dtypes):
            class SoftmaxLoss(mx.operator.CustomOp):
                def forward(self, is_train, req, in_data, out_data, aux):
                    self.assign(out_data[0], req[0],
                                nd.softmax(in_data[0], axis=-1))

                def backward(self, req, out_grad, in_data, out_data,
                             in_grad, aux):
                    y, label = out_data[0], in_data[1]
                    oh = nd.one_hot(label, y.shape[-1], dtype=y.dtype)
                    self.assign(in_grad[0], req[0], y - oh)
                    self.assign(in_grad[1], req[1], nd.zeros_like(label))

            return SoftmaxLoss()

    @mx.operator.register("tt_minmax")
    class MinMaxProp(mx.operator.CustomOpProp):
        def list_outputs(self):
            return ["mn", "mx"]

        def infer_shape(self, in_shape):
            return in_shape, [[in_shape[0][0]], [in_shape[0][0]]], []

        def create_operator(self, ctx, in_shapes, in_dtypes):
            class MinMax(mx.operator.CustomOp):
                def forward(self, is_train, req, in_data, out_data, aux):
                    self.assign(out_data[0], req[0], in_data[0].min(axis=1))
                    self.assign(out_data[1], req[1], in_data[0].max(axis=1))

                def backward(self, req, out_grad, in_data, out_data,
                             in_grad, aux):
                    self.assign(in_grad[0], req[0],
                                out_grad[1].reshape((-1, 1))
                                * nd.ones_like(in_data[0]))

            return MinMax()

    @mx.operator.register("tt_accum")
    class AccumProp(mx.operator.CustomOpProp):
        """Writes with ``req`` "add" over a first "write": 3x."""

        def create_operator(self, ctx, in_shapes, in_dtypes):
            class Accum(mx.operator.CustomOp):
                def forward(self, is_train, req, in_data, out_data, aux):
                    self.assign(out_data[0], "write", in_data[0])
                    self.assign(out_data[0], "add", in_data[0] * 2)
                    self.assign(out_data[0], "null", in_data[0] * 100)

                def backward(self, req, out_grad, in_data, out_data,
                             in_grad, aux):
                    self.assign(in_grad[0], req[0], out_grad[0] * 3)

            return Accum()

    @mx.operator.register("tt_host_read")
    class HostReadProp(mx.operator.CustomOpProp):
        """A forward that reads the host (a scalar of its input)."""

        def create_operator(self, ctx, in_shapes, in_dtypes):
            class HostRead(mx.operator.CustomOp):
                def forward(self, is_train, req, in_data, out_data, aux):
                    self.assign(out_data[0], req[0],
                                in_data[0] * float(in_data[0].asnumpy()
                                                   .max()))

                def backward(self, req, out_grad, in_data, out_data,
                             in_grad, aux):
                    self.assign(in_grad[0], req[0], out_grad[0])

            return HostRead()


_props(jmx, jnd)
_props(tmx, tnd)


def _pair(x):
    """The same numpy array as a JAX-package and a port NDArray (CPU)."""
    with tmx.cpu():
        return jnd.array(x), tnd.array(x)


def _rand(seed, *shape):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def test_custom_registered():
    names = tmx.operator.get_all_registered_operators()
    assert {"tt_sqr", "tt_softmax_loss", "tt_minmax"} <= set(names)
    assert set(names) <= set(jmx.operator.get_all_registered_operators())
    assert hasattr(tnd, "Custom") and hasattr(tmx.sym, "Custom")


@pytest.mark.parametrize("params", [{}, {"scale": 4.0}, {"scale": "0.5"}])
def test_custom_forward_backward_match_jax(params):
    """Eager forward and the user's backward (params reach the prop)."""
    x = _rand(0, 3, 4)
    jx, tx = _pair(x)
    res = []
    for mod, ag, xx in ((jnd, jag, jx), (tnd, tag, tx)):
        xx.attach_grad()
        with ag.record():
            y = mod.Custom(xx, op_type="tt_sqr", **params)
            loss = (y * y).sum()
        loss.backward()
        res.append((y.asnumpy(), xx.grad.asnumpy()))
    np.testing.assert_allclose(res[1][0], res[0][0], **TOL)
    np.testing.assert_allclose(res[1][1], res[0][1], **TOL)
    scale = float(params.get("scale", 2.5))
    np.testing.assert_allclose(res[1][1], scale * 2 * x ** 3,
                               rtol=1e-5)


@pytest.mark.parametrize("label_dtype", ["float32", "int32"])
def test_custom_softmax_loss_grad_matches_jax(label_dtype):
    logits = _rand(1, 6, 5)
    labels = np.array([0, 2, 1, 4, 3, 3]).astype(label_dtype)
    res = []
    for mod, ag in ((jnd, jag), (tnd, tag)):
        with tmx.cpu():
            x, lab = mod.array(logits), mod.array(labels, dtype=label_dtype)
        x.attach_grad()
        with ag.record():
            out = mod.Custom(x, lab, op_type="tt_softmax_loss")
        out.backward()
        res.append((out.asnumpy(), x.grad.asnumpy()))
    np.testing.assert_allclose(res[1][0], res[0][0], **TOL)
    np.testing.assert_allclose(res[1][1], res[0][1], **TOL)


def test_custom_req_write_add_null():
    x = _rand(2, 2, 3)
    jx, tx = _pair(x)
    outs = []
    for mod, ag, xx in ((jnd, jag, jx), (tnd, tag, tx)):
        xx.attach_grad()
        with ag.record():
            y = mod.Custom(xx, op_type="tt_accum")
        y.backward()
        outs.append((y.asnumpy(), xx.grad.asnumpy()))
    np.testing.assert_allclose(outs[1][0], 3 * x, **TOL)
    np.testing.assert_allclose(outs[1][0], outs[0][0], **TOL)
    np.testing.assert_allclose(outs[1][1], outs[0][1], **TOL)


def test_custom_multi_output_matches_jax():
    x = _rand(3, 4, 5)
    jx, tx = _pair(x)
    res = []
    for mod, ag, xx in ((jnd, jag, jx), (tnd, tag, tx)):
        xx.attach_grad()
        with ag.record():
            mn, mxv = mod.Custom(xx, op_type="tt_minmax")
            loss = (mn * 2 + mxv * mxv).sum()
        loss.backward()
        res.append([mn.asnumpy(), mxv.asnumpy(), xx.grad.asnumpy()])
    for a, b in zip(res[1], res[0]):
        np.testing.assert_allclose(a, b, **TOL)
    np.testing.assert_allclose(res[1][0], x.min(1))
    assert tmx.sym.Custom(tmx.sym.var("x"), op_type="tt_minmax") \
        .num_outputs == 2


def _dense_pair(seed, units, in_units):
    """A Dense layer in each package with the same weights."""
    from mxnet_tpu.gluon import nn as jnn
    from mxnet_tpu_torch.gluon import nn as tnn

    rs = np.random.RandomState(seed)
    w = rs.randn(units, in_units).astype(np.float32) * 0.3
    b = rs.randn(units).astype(np.float32) * 0.1
    jd = jnn.Dense(units, in_units=in_units)
    jd.initialize()
    jd.weight.set_data(jnd.array(w))
    jd.bias.set_data(jnd.array(b))
    td = tnn.Dense(units, in_units=in_units, device="cpu").initialize()
    with torch.no_grad():
        td.weight.copy_(torch.from_numpy(w))
        td.bias.copy_(torch.from_numpy(b))
    return jd, td


def test_custom_gluon_training_loop_matches_jax():
    """Ten Adam steps of a Dense layer under the custom softmax loss:
    the same probabilities and weights in both packages (1e-5: ten
    steps of Adam's rsqrt)."""
    from mxnet_tpu.gluon import Trainer as JTrainer
    from mxnet_tpu_torch.gluon import Trainer as TTrainer

    rs = np.random.RandomState(4)
    xs = rs.rand(32, 8).astype(np.float32)
    ys = rs.randint(0, 4, 32).astype(np.float32)
    jd, td = _dense_pair(5, 4, 8)
    runs = []
    for mod, ag, net, trainer_cls in ((jnd, jag, jd, JTrainer),
                                      (tnd, tag, td, TTrainer)):
        trainer = trainer_cls(net.collect_params(), "adam",
                              {"learning_rate": 2e-2})
        with tmx.cpu():
            x, y = mod.array(xs), mod.array(ys)
        for _ in range(10):
            with ag.record():
                prob = mod.Custom(net(x), y, op_type="tt_softmax_loss")
            prob.backward()
            trainer.step(32)
        w = net.weight.data() if mod is jnd else net.weight.detach()
        runs.append((prob.asnumpy(), np.asarray(w.asnumpy() if mod is jnd
                                                else w.numpy())))
    np.testing.assert_allclose(runs[1][0], runs[0][0], rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(runs[1][1], runs[0][1], rtol=1e-5,
                               atol=1e-6)


def test_custom_under_hybridize_matches_eager_and_jax():
    """A hybridized block holding a Custom op: the same output and input
    gradient as the eager block and the JAX package's."""
    from mxnet_tpu_torch.gluon import HybridBlock

    class Net(HybridBlock):
        def __init__(self, dense, **kw):
            super().__init__(**kw)
            self.fc = dense

        def hybrid_forward(self, F, x):
            return F.Custom(self.fc(x), op_type="tt_sqr")

    x = _rand(6, 2, 3)
    jd, td = _dense_pair(7, 3, 3)
    jx = jnd.array(x)
    jx.attach_grad()
    with jag.record():
        jy = jnd.Custom(jd(jx), op_type="tt_sqr")
    jy.backward()
    net = Net(td)
    got = []
    for hybrid in (False, True):
        if hybrid:
            net.hybridize()
        with tmx.cpu():
            tx = tnd.array(x)
        tx.attach_grad()
        with tag.record():
            ty = net(tx)
        ty.backward()
        got.append((ty.asnumpy(), tx.grad.asnumpy()))
    for y, g in got:
        np.testing.assert_allclose(y, jy.asnumpy(), **TOL)
        np.testing.assert_allclose(g, jx.grad.asnumpy(), **TOL)
    assert np.array_equal(got[0][0], got[1][0])


def test_custom_symbol_module_fit():
    """``sym.Custom`` names its label from the prop's arguments, infers
    shapes from the prop, and trains under ``Module.fit``."""
    rs = np.random.RandomState(4)
    w = rs.randn(6, 3).astype(np.float32)
    xs = rs.rand(240, 6).astype(np.float32)
    ys = (xs @ w).argmax(1).astype(np.float32)

    sym = tmx.sym
    net = sym.FullyConnected(sym.var("data"), num_hidden=3, name="fc")
    out = sym.Custom(data=net, op_type="tt_softmax_loss", name="softmax")
    jnet = jmx.sym.FullyConnected(jmx.sym.var("data"), num_hidden=3,
                                  name="fc")
    jout = jmx.sym.Custom(data=jnet, op_type="tt_softmax_loss",
                          name="softmax")
    assert out.list_arguments() == jout.list_arguments()
    assert "softmax_label" in out.list_arguments()
    assert out.infer_shape(data=(48, 6), softmax_label=(48,))[1] == \
        [(48, 3)]
    with tmx.cpu():
        train = tmx.io.NDArrayIter(xs, ys, batch_size=48, shuffle=True,
                                   label_name="softmax_label")
        mod = tmx.module.Module(out, label_names=["softmax_label"],
                                context=tmx.cpu())
        tmx.random.seed(0)
        mod.fit(train, num_epoch=40, optimizer="adam",
                optimizer_params={"learning_rate": 2e-2})
        preds = mod.predict(tmx.io.NDArrayIter(
            xs, ys, batch_size=48, label_name="softmax_label"))
    acc = (preds.asnumpy().argmax(1) == ys).mean()
    assert acc > 0.85, acc


def test_custom_symbol_infer_shape_uses_the_prop():
    """Shapes come from the prop's ``infer_shape``: a forward that
    reads the host still infers (it never runs on ``meta``)."""
    sym = tmx.sym
    out = sym.Custom(data=sym.var("data"), label=sym.var("lab"),
                     op_type="tt_softmax_loss")
    jout = jmx.sym.Custom(data=jmx.sym.var("data"),
                          label=jmx.sym.var("lab"),
                          op_type="tt_softmax_loss")
    got = out.infer_shape(data=(7, 9), lab=(7,))
    want = jout.infer_shape(data=(7, 9), lab=(7,))
    assert [tuple(s) for s in got[1]] == [tuple(s) for s in want[1]]
    host = sym.Custom(sym.var("x"), op_type="tt_host_read")
    assert host.infer_shape(x=(2, 5))[1] == [(2, 5)]
    # a node of several outputs answers its first, as the JAX package's
    mm = sym.Custom(sym.var("x"), op_type="tt_minmax")
    jmm = jmx.sym.Custom(jmx.sym.var("x"), op_type="tt_minmax")
    assert mm.infer_shape(x=(4, 3))[1] == \
        [tuple(s) for s in jmm.infer_shape(x=(4, 3))[1]] == [(4,)]


def test_custom_errors():
    with tmx.cpu():
        z = tnd.zeros((2, 2))
    with pytest.raises(tmx.MXNetError, match="not registered"):
        tnd.Custom(z, op_type="nope_never_registered")
    with pytest.raises(tmx.MXNetError, match="positionally"):
        tnd.Custom(data=z, op_type="tt_sqr")
    with pytest.raises(tmx.MXNetError, match="expects a CustomOpProp"):
        tmx.operator.register("tt_bad")(object)
    with pytest.raises(tmx.MXNetError, match="declares 2 arguments"):
        tnd.Custom(z, op_type="tt_softmax_loss")

    @tmx.operator.register("tt_aux")
    class AuxProp(tmx.operator.CustomOpProp):
        def list_auxiliary_states(self):
            return ["state"]

    with pytest.raises(tmx.MXNetError, match="auxiliary states"):
        tnd.Custom(z, op_type="tt_aux")


def test_custom_callable_is_cached_per_instantiation():
    from mxnet_tpu_torch import operator

    operator._build_custom_fn.cache_clear()
    with tmx.cpu():
        x = tnd.ones((2, 2))
    for _ in range(3):
        tnd.Custom(x, op_type="tt_sqr")
    tnd.Custom(x, op_type="tt_sqr", scale=3)
    with tag.record():
        tnd.Custom(x, op_type="tt_sqr")
    info = operator._build_custom_fn.cache_info()
    assert (info.misses, info.hits) == (3, 2)


@pytest.mark.parametrize("single", [True, False])
def test_autograd_function_matches_jax(single):
    """``autograd.Function``: forward runs paused, the user's backward
    gives the gradient (one output or two), saved arrays round-trip."""

    def make(ag, nd):
        class Sig(ag.Function):
            def forward(self, x):
                y = 1 / (1 + nd.exp(-x))
                self.save_for_backward(y)
                if single:
                    return y
                return y, y * 3

            def backward(self, *dys):
                y, = self.saved_tensors
                g = dys[0] * y * (1 - y)
                if not single:
                    g = g + dys[1] * 0.5
                return g
        return Sig()

    x = _rand(8, 5)
    jx, tx = _pair(x)
    res = []
    for ag, nd, xx in ((jag, jnd, jx), (tag, tnd, tx)):
        f = make(ag, nd)
        xx.attach_grad()
        with ag.record():
            out = f(xx)
            head = out if single else out[0] + out[1]
        head.backward()
        first = out if single else out[0]
        res.append((first.asnumpy(), xx.grad.asnumpy()))
        assert single == (not isinstance(out, list))
    np.testing.assert_allclose(res[1][0], res[0][0], **TOL)
    np.testing.assert_allclose(res[1][1], res[0][1], **TOL)
    # outside record(): the forward alone, paused, no graph
    y = make(tag, tnd)(tx)
    y = y if single else y[0]
    assert isinstance(y, tnd.NDArray) and not y.requires_grad
