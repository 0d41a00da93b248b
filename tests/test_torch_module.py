"""The port's ``Module``, ``BucketingModule``, ``model`` checkpoints and
``callback``s against the JAX package's, on the CPU.

Both packages bind the same graph (built inside a fresh ``NameManager``)
and start from the same numpy-seeded parameters (``arg_params``: the
two packages' initializers draw different bits by design). Tolerances
in float32: outputs within 1e-5 of the JAX output's largest magnitude,
updated parameters within 1e-4 of the JAX parameter's. Checkpoints go
both ways: written by one package, predicted from by the other's
``Module.load`` and ``SymbolBlock.imports``.
"""
import os

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import nd

torch.set_num_threads(1)

D, C = 6, 3


def mlp(mx):
    with mx.name.NameManager():
        data = mx.sym.var("data")
        net = mx.sym.FullyConnected(data, num_hidden=8, name="fc1")
        net = mx.sym.Activation(net, act_type="tanh", name="act1")
        net = mx.sym.FullyConnected(net, num_hidden=C, name="fc2")
        return mx.sym.SoftmaxOutput(net, name="softmax")


def toy_data(n, seed=0):
    rs = np.random.RandomState(seed)
    w = rs.randn(D, C).astype(np.float32)
    x = rs.randn(n, D).astype(np.float32)
    y = (x @ w).argmax(1).astype(np.float32)
    return x, y


def init_args(sym, shapes, seed=1):
    arg_shapes, _, _ = sym.infer_shape(**shapes)
    rs = np.random.RandomState(seed)
    return {n: (0.5 * rs.randn(*s)).astype(np.float32)
            for n, s in zip(sym.list_arguments(), arg_shapes)
            if n not in shapes}


def close(got, want, tol, what=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-30)
    gap = float(np.abs(got - want).max())
    assert gap <= tol * scale, f"{what}: {gap} > {tol} x {scale}"


def both_params(jmod, tmod, tol=1e-4):
    jargs, _ = jmod.get_params()
    targs, _ = tmod.get_params()
    assert sorted(targs) == sorted(jargs)
    for name, v in jargs.items():
        close(targs[name].asnumpy(), v.asnumpy(), tol, name)


def jbatch(x, y, **kw):
    return jmx.io.DataBatch(data=[jmx.nd.array(x)], label=[jmx.nd.array(y)],
                            **kw)


def tbatch(x, y, **kw):
    return tmx.io.DataBatch(data=[nd.array(x, ctx=tmx.cpu())],
                            label=[nd.array(y, ctx=tmx.cpu())], **kw)


def bound_pair(batch=8, for_training=True):
    jmod = jmx.mod.Module(mlp(jmx), context=jmx.cpu())
    tmod = tmx.mod.Module(mlp(tmx), context=tmx.cpu())
    shapes = dict(data=(batch, D), softmax_label=(batch,))
    args = init_args(tmod.symbol, shapes)
    for mx, mod in ((jmx, jmod), (tmx, tmod)):
        mod.bind(data_shapes=[("data", (batch, D))],
                 label_shapes=[("softmax_label", (batch,))],
                 for_training=for_training)
        ctx = {} if mx is jmx else {"ctx": tmx.cpu()}
        mod.init_params(arg_params={k: mx.nd.array(v, **ctx)
                                    for k, v in args.items()})
    return jmod, tmod


@pytest.mark.parametrize("opt", [
    ("sgd", {"learning_rate": 0.1, "momentum": 0.9, "wd": 1e-3}),
    ("adam", {"learning_rate": 0.01})], ids=["sgd_momentum", "adam"])
def test_module_updates_equal_the_jax_package(opt):
    """bind, init_params, init_optimizer, then three
    forward_backward + update steps: outputs, input gradients and
    parameters after each step."""
    name, params = opt
    jmod, tmod = bound_pair()
    for mod in (jmod, tmod):
        mod.init_optimizer(optimizer=name, optimizer_params=params)
    x, y = toy_data(24)
    for step in range(3):
        sl = slice(8 * step, 8 * step + 8)
        jmod.forward_backward(jbatch(x[sl], y[sl]))
        tmod.forward_backward(tbatch(x[sl], y[sl]))
        close(tmod.get_outputs()[0].asnumpy(),
              jmod.get_outputs()[0].asnumpy(), 1e-5, f"outputs {step}")
        jmod.update()
        tmod.update()
        both_params(jmod, tmod)
    assert tmod.output_shapes == [("softmax_output", (8, C))]


def test_fit_score_predict_equal_the_jax_package(tmp_path):
    """``fit`` (2 epochs of SGD from the same weights, a checkpoint each
    epoch, a Speedometer and a Monitor), ``score`` and ``predict`` over
    a padded last batch."""
    x, y = toy_data(64)
    xe, ye = toy_data(60, seed=3)
    jmod = jmx.mod.Module(mlp(jmx), context=jmx.cpu())
    tmod = tmx.mod.Module(mlp(tmx), context=tmx.cpu())
    args = init_args(tmod.symbol, dict(data=(16, D), softmax_label=(16,)))
    prefix = str(tmp_path / "fit")
    mon = tmx.monitor.Monitor(1, pattern="softmax.*")
    with tmx.cpu():
        tit = tmx.io.NDArrayIter(x, y, batch_size=16,
                                 label_name="softmax_label")
        teval = tmx.io.NDArrayIter(xe, ye, batch_size=16,
                                   label_name="softmax_label")
        tmod.fit(tit, num_epoch=2, optimizer="sgd",
                 optimizer_params={"learning_rate": 0.05},
                 arg_params={k: nd.array(v) for k, v in args.items()},
                 batch_end_callback=tmx.callback.Speedometer(16, 2),
                 epoch_end_callback=tmx.callback.do_checkpoint(prefix),
                 monitor=mon)
    jit = jmx.io.NDArrayIter(x, y, batch_size=16, label_name="softmax_label")
    jeval = jmx.io.NDArrayIter(xe, ye, batch_size=16,
                               label_name="softmax_label")
    jmod.fit(jit, num_epoch=2, optimizer="sgd",
             optimizer_params={"learning_rate": 0.05},
             arg_params={k: jmx.nd.array(v) for k, v in args.items()})
    both_params(jmod, tmod)
    assert os.path.exists(prefix + "-symbol.json")
    assert os.path.exists(prefix + "-0002.params")
    assert mon.exes == [tmod._exec]
    tacc = dict(tmod.score(teval, "acc"))["accuracy"]
    jacc = dict(jmod.score(jeval, "acc"))["accuracy"]
    assert tacc == pytest.approx(jacc)
    tpred = tmod.predict(teval)
    jpred = jmod.predict(jeval)
    assert tpred.shape == (60, C)
    close(tpred.asnumpy(), jpred.asnumpy(), 1e-5, "predict")


def test_predict_batches_stay_valid_after_the_next_batch():
    """Each batch's outputs are the executor's own copies: predicting
    three batches unmerged gives each batch's own forward."""
    _, tmod = bound_pair(batch=8, for_training=False)
    x, y = toy_data(24, seed=4)
    with tmx.cpu():
        it = tmx.io.NDArrayIter(x, y, batch_size=8,
                                label_name="softmax_label")
    outs = tmod.predict(it, merge_batches=False)
    assert len(outs) == 3
    for i, (o,) in enumerate(outs):
        tmod.forward(tbatch(x[8 * i:8 * i + 8], y[8 * i:8 * i + 8]),
                     is_train=False)
        np.testing.assert_array_equal(o.asnumpy(),
                                      tmod.get_outputs()[0].asnumpy())


def lstm_gen(mx, hidden=5):
    def gen(seq_len):
        with mx.name.NameManager():
            data = mx.sym.Variable("data")
            label = mx.sym.Variable("softmax_label")
            cell = mx.rnn.LSTMCell(num_hidden=hidden, prefix="lstm_")
            outputs, _ = cell.unroll(seq_len, data, layout="NTC",
                                     merge_outputs=False)
            fc = mx.sym.FullyConnected(outputs[-1], num_hidden=2, name="fc")
            return (mx.sym.SoftmaxOutput(fc, label, name="softmax"),
                    ["data"], ["softmax_label"])
    return gen


def test_bucketing_module_equals_the_jax_package():
    """Two buckets (lengths 5 and 3) sharing one set of parameters and
    one Adam optimizer: outputs and parameters after each of four
    steps, the buckets' parameter arrays one storage."""
    batch, feat = 4, 3
    jmod = jmx.mod.BucketingModule(lstm_gen(jmx), default_bucket_key=5,
                                   context=jmx.cpu())
    tmod = tmx.mod.BucketingModule(lstm_gen(tmx), default_bucket_key=5,
                                   context=tmx.cpu())
    sym5 = lstm_gen(tmx)(5)[0]
    args = init_args(sym5, dict(data=(batch, 5, feat),
                                softmax_label=(batch,)))
    for mx, mod in ((jmx, jmod), (tmx, tmod)):
        mod.bind(data_shapes=[("data", (batch, 5, feat))],
                 label_shapes=[("softmax_label", (batch,))])
        ctx = {} if mx is jmx else {"ctx": tmx.cpu()}
        mod.init_params(arg_params={k: mx.nd.array(v, **ctx)
                                    for k, v in args.items()})
        mod.init_optimizer(optimizer="adam",
                           optimizer_params={"learning_rate": 0.05})
    rs = np.random.RandomState(7)
    for blen in (5, 3, 5, 3):
        x = rs.randn(batch, blen, feat).astype(np.float32)
        y = rs.randint(0, 2, batch).astype(np.float32)
        kw = dict(bucket_key=blen, provide_data=[("data", (batch, blen, feat))],
                  provide_label=[("softmax_label", (batch,))])
        jmod.forward_backward(jbatch(x, y, **kw))
        tmod.forward_backward(tbatch(x, y, **kw))
        close(tmod.get_outputs()[0].asnumpy(),
              jmod.get_outputs()[0].asnumpy(), 1e-5, f"bucket {blen}")
        jmod.update()
        tmod.update()
        both_params(jmod, tmod)
    mods = tmod._buckets
    assert sorted(mods) == [3, 5]
    for name in mods[5]._param_names:
        assert mods[3]._exec.arg_dict[name] is mods[5]._exec.arg_dict[name]
    assert mods[3]._exec._graph_cache is mods[5]._exec._graph_cache


def _eval_iter(mx, x, y, **ctx):
    return mx.io.NDArrayIter(x, y, batch_size=8, label_name="softmax_label",
                             **ctx)


def test_checkpoints_go_both_ways(tmp_path):
    """The port writes a checkpoint that the JAX package's
    ``load_checkpoint``/``Module.load`` and ``SymbolBlock.imports``
    predict from, and reads the JAX package's back the same two ways."""
    jmod, tmod = bound_pair()
    for mod in (jmod, tmod):
        mod.init_optimizer(optimizer="sgd",
                           optimizer_params={"learning_rate": 0.3})
    x, y = toy_data(16, seed=5)
    for step in range(2):
        sl = slice(8 * step, 8 * step + 8)
        jmod.forward_backward(jbatch(x[sl], y[sl]))
        tmod.forward_backward(tbatch(x[sl], y[sl]))
        jmod.update()
        tmod.update()
    tprefix, jprefix = str(tmp_path / "port"), str(tmp_path / "jax")
    tmod.save_checkpoint(tprefix, 2)
    jmod.save_checkpoint(jprefix, 2)
    with tmx.cpu():
        want = tmod.predict(_eval_iter(tmx, x, y)).asnumpy()

    def jax_predicts(prefix):
        sym, args, auxs = jmx.model.load_checkpoint(prefix, 2)
        assert sorted(args) == ["fc1_bias", "fc1_weight", "fc2_bias",
                                "fc2_weight"] and not auxs
        mod = jmx.mod.Module.load(prefix, 2, label_names=["softmax_label"])
        mod.bind(data_shapes=[("data", (8, D))],
                 label_shapes=[("softmax_label", (8,))], for_training=False)
        mod.init_params(arg_params=mod._preloaded_params[0],
                        aux_params=mod._preloaded_params[1])
        block = jmx.gluon.SymbolBlock.imports(
            prefix + "-symbol.json", ["data", "softmax_label"],
            prefix + "-0002.params")
        return (mod.predict(_eval_iter(jmx, x, y)).asnumpy(),
                block(jmx.nd.array(x), jmx.nd.array(y)).asnumpy())

    def port_predicts(prefix):
        with tmx.cpu():
            sym, args, auxs = tmx.model.load_checkpoint(prefix, 2)
            assert sorted(args) == ["fc1_bias", "fc1_weight", "fc2_bias",
                                    "fc2_weight"] and not auxs
            mod = tmx.mod.Module.load(prefix, 2,
                                      label_names=["softmax_label"])
            mod.bind(data_shapes=[("data", (8, D))],
                     label_shapes=[("softmax_label", (8,))],
                     for_training=False)
            mod.init_params(arg_params=mod._preloaded_params[0],
                            aux_params=mod._preloaded_params[1])
            block = tmx.gluon.SymbolBlock.imports(
                prefix + "-symbol.json", ["data", "softmax_label"],
                prefix + "-0002.params")
            return (mod.predict(_eval_iter(tmx, x, y)).asnumpy(),
                    block(nd.array(x), nd.array(y)).asnumpy())

    for got in jax_predicts(tprefix) + port_predicts(jprefix) + \
            port_predicts(tprefix):
        close(got, want, 1e-5)


def test_optimizer_states_round_trip(tmp_path):
    _, tmod = bound_pair()
    tmod.init_optimizer(optimizer="sgd",
                        optimizer_params={"learning_rate": 0.1,
                                          "momentum": 0.9})
    x, y = toy_data(16, seed=6)
    tmod.forward_backward(tbatch(x[:8], y[:8]))
    tmod.update()
    fname = str(tmp_path / "m.states")
    tmod.save_optimizer_states(fname)
    args, _ = tmod.get_params()
    _, other = bound_pair()
    other.init_params(arg_params=args, force_init=True)
    other.init_optimizer(optimizer="sgd",
                         optimizer_params={"learning_rate": 0.1,
                                           "momentum": 0.9})
    other.load_optimizer_states(fname)
    for mod in (tmod, other):
        mod.forward_backward(tbatch(x[8:], y[8:]))
        mod.update()
    a, _ = tmod.get_params()
    b, _ = other.get_params()
    for name in a:
        np.testing.assert_array_equal(a[name].asnumpy(), b[name].asnumpy())


def test_callbacks():
    calls = []
    metric = tmx.metric.Accuracy()
    metric.update([nd.array([1.0, 0.0], ctx=tmx.cpu())],
                  [nd.array([[0.2, 0.8], [0.9, 0.1]], ctx=tmx.cpu())])
    param = tmx.model.BatchEndParam(epoch=0, nbatch=0, eval_metric=metric,
                                    locals={})
    tmx.callback.log_train_metric(1)(param)
    tmx.callback.ProgressBar(4)(param)
    speed = tmx.callback.Speedometer(2, frequent=1)
    speed(param)
    speed(param._replace(nbatch=1))

    class Mod:
        def save_checkpoint(self, prefix, epoch, states):
            calls.append((prefix, epoch, states))

    tmx.callback.module_checkpoint(Mod(), "p", period=2)(1)
    tmx.callback.module_checkpoint(Mod(), "p", period=2)(2)
    assert calls == [("p", 2, False)]


def test_a_context_list_of_two_devices_raises():
    with pytest.raises(ValueError, match=r"\[cpu\(0\), cpu\(1\)\]"):
        tmx.mod.Module(mlp(tmx), context=[tmx.cpu(0), tmx.cpu(1)])
    mod = tmx.mod.Module(mlp(tmx), context=[tmx.cpu(0)])
    assert mod._context == tmx.cpu(0)
