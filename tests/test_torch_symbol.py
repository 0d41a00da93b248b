"""The port's symbolic API (``mx.sym``, ``Executor``, ``Monitor``,
``SymbolBlock`` and ``HybridBlock.export``) against the JAX package's,
on the CPU.

Both packages build each graph with the same names (inside a fresh
``NameManager``, so no test depends on another's counters) and get the
same numpy-seeded arguments. Tolerances in float32: outputs within 1e-5
of the JAX output's largest magnitude, gradients within 1e-4 of the
JAX gradient's. The graphs: an MLP, a conv net with BatchNorm, an
unrolled ``mx.rnn.LSTMCell`` and ``sym.RNN`` with every shape given.
On the CPU the port's executor runs its graph entry (the walk in place
of a CUDA graph); ``MXNET_TPU_SYMBOLIC_JIT=0`` runs the eager walk.
"""
import os

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import gluon, graphs, nd
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.gluon import nn
from mxnet_tpu_torch.ndarray.op_impl_rnn import rnn_param_size
from mxnet_tpu_torch.ops import _build

torch.set_num_threads(1)

RNN_P = rnn_param_size(2, 8, 8, False, "lstm")


def mlp(mx):
    data = mx.sym.var("data")
    net = mx.sym.FullyConnected(data, num_hidden=16, name="fc1")
    net = mx.sym.Activation(net, act_type="tanh", name="act1")
    net = mx.sym.FullyConnected(net, num_hidden=3, name="fc2")
    return mx.sym.SoftmaxOutput(net, name="softmax")


def conv_bn(mx):
    data = mx.sym.var("data")
    net = mx.sym.Convolution(data, kernel=(3, 3), num_filter=4, pad=(1, 1),
                             name="conv1")
    net = mx.sym.BatchNorm(net, fix_gamma=False, name="bn1")
    net = mx.sym.Activation(net, act_type="relu", name="relu1")
    net = mx.sym.Pooling(net, kernel=(2, 2), stride=(2, 2), pool_type="max",
                         name="pool1")
    net = mx.sym.Flatten(net, name="flat")
    net = mx.sym.FullyConnected(net, num_hidden=5, name="fc")
    return mx.sym.SoftmaxOutput(net, name="softmax")


def lstm_cell(mx):
    cell = mx.rnn.LSTMCell(num_hidden=6, prefix="lstm_")
    outs, _ = cell.unroll(4, mx.sym.var("data"), layout="NTC",
                          merge_outputs=True)
    return mx.sym.FullyConnected(outs, num_hidden=2, name="fc")


def rnn_op(mx):
    data = mx.sym.var("data")
    emb = mx.sym.Embedding(data, input_dim=50, output_dim=8, name="embed")
    r = mx.sym.RNN(emb, state_size=8, num_layers=2, mode="lstm",
                   state_outputs=True, name="lstm")
    out = mx.sym.Reshape(r[0], shape=(-1, 8), name="flat")
    fc = mx.sym.FullyConnected(out, num_hidden=50, name="dec")
    return mx.sym.Group([mx.sym.SoftmaxOutput(fc, name="softmax"),
                         mx.sym.BlockGrad(r[1], name="h"),
                         mx.sym.BlockGrad(r[2], name="c")])


GRAPHS = {
    "mlp": (mlp, dict(data=(4, 8))),
    "conv_bn": (conv_bn, dict(data=(2, 3, 8, 8))),
    "lstm_cell": (lstm_cell, dict(data=(3, 4, 5))),
    "rnn_op": (rnn_op, dict(data=(5, 3), lstm_parameters=(RNN_P,),
                            lstm_state=(2, 3, 8), lstm_state_cell=(2, 3, 8))),
}


def build(mx, fn):
    with mx.name.NameManager():
        return fn(mx)


def arguments(sym, shapes, seed=0):
    """numpy arguments for every input of ``sym`` (labels and ids as
    class indices, the rest N(0, 0.5))."""
    arg_shapes, _, _ = sym.infer_shape(**shapes)
    rs = np.random.RandomState(seed)
    out = {}
    for name, shape in zip(sym.list_arguments(), arg_shapes):
        if name.endswith("label"):
            out[name] = rs.randint(0, 3, shape).astype(np.float32)
        elif name == "data" and "embed" in " ".join(sym.list_arguments()):
            out[name] = rs.randint(0, 50, shape).astype(np.float32)
        elif name.endswith(("moving_var", "gamma")):
            out[name] = rs.uniform(0.5, 1.5, shape).astype(np.float32)
        else:
            out[name] = (0.5 * rs.randn(*shape)).astype(np.float32)
    return out


def close(got, want, tol, what=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-30)
    gap = float(np.abs(got - want).max())
    assert gap <= tol * scale, f"{what}: {gap} > {tol} x {scale}"


def bind_both(fn, shapes, grad_req="write", seed=0):
    js, ts = build(jmx, fn), build(tmx, fn)
    args = arguments(ts, shapes, seed)
    jex = js.bind(jmx.cpu(), {k: jmx.nd.array(v) for k, v in args.items()},
                  grad_req=grad_req)
    tex = ts.bind(tmx.cpu(), {k: nd.array(v, ctx=tmx.cpu())
                              for k, v in args.items()}, grad_req=grad_req)
    return jex, tex, args


@pytest.mark.parametrize("graph", sorted(GRAPHS))
def test_tojson_and_infer_shape_equal_the_jax_package(graph):
    fn, shapes = GRAPHS[graph]
    js, ts = build(jmx, fn), build(tmx, fn)
    assert ts.tojson() == js.tojson()
    assert ts.list_arguments() == js.list_arguments()
    assert ts.list_outputs() == js.list_outputs()
    assert ts.infer_shape(**shapes) == js.infer_shape(**shapes)
    # a partial shape set leaves the answer unknown in both
    if graph == "rnn_op":
        partial = {k: v for k, v in shapes.items() if k != "lstm_parameters"}
        assert ts.infer_shape(**partial) == js.infer_shape(**partial) \
            == (None, None, None)


@pytest.mark.parametrize("grad_req", ["write", "add", "null"])
@pytest.mark.parametrize("graph", ["mlp", "conv_bn", "rnn_op"])
def test_executor_forward_backward_equal_the_jax_package(graph, grad_req):
    """Forward in train mode, backward with the loss heads' own
    gradients; ``add`` runs it twice (the gradients accumulate)."""
    fn, shapes = GRAPHS[graph]
    jex, tex, _ = bind_both(fn, shapes, grad_req)
    for _ in range(2 if grad_req == "add" else 1):
        jouts = jex.forward(is_train=True)
        touts = tex.forward(is_train=True)
        jex.backward()
        tex.backward()
    for j, t in zip(jouts, touts):
        assert isinstance(t, nd.NDArray)
        close(t.asnumpy(), j.asnumpy(), 1e-5, "output")
    if grad_req == "null":
        assert not tex.grad_dict
        return
    assert sorted(tex.grad_dict) == sorted(jex.grad_dict)
    for name, g in jex.grad_dict.items():
        close(tex.grad_dict[name].asnumpy(), g.asnumpy(), 1e-4, name)


def test_executor_out_grads_and_predict_mode():
    """A graph with no loss head: ``backward(out_grads)``, and a
    predict-mode forward (Dropout off) equal to the JAX package's."""
    def net(mx):
        x = mx.sym.var("data")
        h = mx.sym.FullyConnected(x, num_hidden=6, name="fc")
        h = mx.sym.Dropout(h, p=0.5, name="drop")
        return mx.sym.tanh(h * 2.0 + 1.0, name="out")

    jex, tex, _ = bind_both(net, dict(data=(4, 5)))
    rs = np.random.RandomState(1)
    head = rs.randn(4, 6).astype(np.float32)
    jout = jex.forward(is_train=False)[0].asnumpy()
    tout = tex.forward(is_train=False)[0].asnumpy()
    close(tout, jout, 1e-5, "predict")
    tmx.random.seed(0)
    tex.forward(is_train=True)
    tmask = (np.abs(tex.outputs[0].asnumpy() - np.tanh(1.0)) > 1e-6).mean()
    assert 0.2 < tmask < 0.8            # dropout ran in train mode
    # backward with a head gradient, on a forward without dropout
    jex2, tex2, _ = bind_both(
        lambda mx: mx.sym.tanh(mx.sym.FullyConnected(
            mx.sym.var("data"), num_hidden=6, name="fc") * 2.0 + 1.0,
            name="out"), dict(data=(4, 5)))
    jex2.forward(is_train=True)
    tex2.forward(is_train=True)
    jex2.backward(jmx.nd.array(head))
    tex2.backward(nd.array(head, ctx=tmx.cpu()))
    for name, g in jex2.grad_dict.items():
        close(tex2.grad_dict[name].asnumpy(), g.asnumpy(), 1e-4, name)


def test_graph_entry_equals_the_eager_walk(monkeypatch):
    """The executor's entry (graphs' stand-in on the CPU) against
    ``MXNET_TPU_SYMBOLIC_JIT=0``'s eager walk: the same bits; one entry
    a key, counted as a capture."""
    fn, shapes = GRAPHS["rnn_op"]
    _, tex, args = bind_both(fn, shapes)
    before = graphs.captures()
    outs = [o.asnumpy() for o in tex.forward(is_train=True)]
    tex.backward()
    grads = {k: v.asnumpy().copy() for k, v in tex.grad_dict.items()}
    tex.forward(is_train=True)
    tex.backward()
    assert graphs.captures() - before == 1
    assert len(tex._graph_cache.entries) == 1
    monkeypatch.setenv("MXNET_TPU_SYMBOLIC_JIT", "0")
    ts = build(tmx, fn)
    eager = ts.bind(tmx.cpu(), {k: nd.array(v, ctx=tmx.cpu())
                                for k, v in args.items()})
    assert not eager._jit
    for o, want in zip(eager.forward(is_train=True), outs):
        np.testing.assert_array_equal(o.asnumpy(), want)
    eager.backward()
    for k, g in grads.items():
        np.testing.assert_array_equal(eager.grad_dict[k].asnumpy(), g)
    assert not eager._graph_cache.entries


def test_reshape_shares_the_graph_cache_and_in_place_writes_are_read():
    fn, shapes = GRAPHS["mlp"]
    _, tex, args = bind_both(fn, shapes)
    tex.forward(is_train=False)
    small = tex.reshape(data=(2, 8), softmax_label=(2,))
    assert small._graph_cache is tex._graph_cache
    assert small.arg_dict["fc1_weight"] is tex.arg_dict["fc1_weight"]
    x = np.random.RandomState(3).randn(2, 8).astype(np.float32)
    got = small.forward(data=nd.array(x, ctx=tmx.cpu()))[0].asnumpy()
    assert len(tex._graph_cache.entries) == 2
    # a weight written in place is what the next call reads
    with torch.no_grad():
        small.arg_dict["fc2_bias"] += 1.0
    again = small.forward()[0].asnumpy()
    w1, b1 = args["fc1_weight"], args["fc1_bias"]
    w2, b2 = args["fc2_weight"], args["fc2_bias"]

    def want(bias):
        z = np.tanh(x @ w1.T + b1) @ w2.T + bias
        z = np.exp(z - z.max(1, keepdims=True))
        return z / z.sum(1, keepdims=True)
    np.testing.assert_allclose(got, want(b2), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(again, want(b2 + 1.0), rtol=1e-5, atol=1e-6)
    assert len(tex._graph_cache.entries) == 2       # no new key


def test_arithmetic_slicing_json_round_trip_and_eval():
    def net(mx):
        a, b = mx.sym.var("a"), mx.sym.var("b")
        parts = mx.sym.split(a, num_outputs=2, axis=1, name="sp")
        c = (parts[0] * 2.0 - b) / (parts[1] + 3.0)
        return mx.sym.Group([c ** 2.0, -c, (c > 0.1) + 0.0,
                             mx.sym.sum(c, axis=1, keepdims=True)])

    js, ts = build(jmx, net), build(tmx, net)
    assert ts.tojson() == js.tojson()
    rs = np.random.RandomState(2)
    a = rs.randn(3, 4).astype(np.float32)
    b = rs.randn(3, 2).astype(np.float32)
    touts = tmx.sym.load_json(ts.tojson()).eval(
        tmx.cpu(), a=nd.array(a, ctx=tmx.cpu()), b=nd.array(b, ctx=tmx.cpu()))
    jouts = js.eval(jmx.cpu(), a=jmx.nd.array(a), b=jmx.nd.array(b))
    for t, j in zip(touts, jouts):
        close(t.asnumpy(), j.asnumpy(), 1e-5)
    internals = ts.get_internals()
    assert "sp_output1" in internals.list_outputs()


def test_jax_saved_symbol_json_loads_and_evaluates_equal(tmp_path):
    fn, shapes = GRAPHS["conv_bn"]
    js = build(jmx, fn)
    js.save(str(tmp_path / "net-symbol.json"))
    ts = tmx.sym.load(str(tmp_path / "net-symbol.json"))
    assert ts.tojson() == js.tojson()
    args = arguments(ts, shapes)
    jout = js.bind(jmx.cpu(), {k: jmx.nd.array(v) for k, v in args.items()}) \
        .forward()[0].asnumpy()
    tout = ts.bind(tmx.cpu(), {k: nd.array(v, ctx=tmx.cpu())
                               for k, v in args.items()}).forward()[0]
    close(tout.asnumpy(), jout, 1e-5)
    # and the port's file loads into the JAX package
    ts.save(str(tmp_path / "port-symbol.json"))
    assert jmx.sym.load(str(tmp_path / "port-symbol.json")).tojson() == \
        js.tojson()


def test_waiting_names_raise_naming_their_roadmap_item():
    with pytest.raises(NotImplementedError, match="ROADMAP Queue 1"):
        tmx.sym.ctc_loss
    with pytest.raises(NotImplementedError, match="Long tail"):
        tmx.sym.contrib.MultiBoxPrior(tmx.sym.var("x"), sizes=(0.5,))
    js = jmx.sym.contrib.MultiBoxPrior(jmx.sym.var("x"), sizes=(0.5,),
                                       name="prior")
    with pytest.raises(NotImplementedError, match="Long tail"):
        tmx.sym.load_json(js.tojson())


def test_meta_shape_inference_launches_nothing(monkeypatch):
    """``infer_shape`` runs each node on ``meta`` tensors: the kernels'
    wrappers (LayerNorm, flash attention, softmax cross-entropy, the
    LSTM) compute shapes there and never reach a launch; the shapes are
    the JAX package's."""
    def net(mx):
        x = mx.sym.var("x")
        h = mx.sym.LayerNorm(x, name="ln")
        q = mx.sym.Reshape(h, shape=(2, 8, 2, 4), name="heads")
        q = mx.sym.transpose(q, axes=(0, 2, 1, 3), name="bhsd")
        att = mx.sym.flash_attention(q, q, q, name="att")
        flat = mx.sym.Reshape(att, shape=(-1, 4), name="rows")
        loss = mx.sym.softmax_cross_entropy(flat, mx.sym.var("label"),
                                            name="xent")
        seq = mx.sym.Reshape(h, shape=(8, 2, 8), name="seq")
        r = mx.sym.RNN(seq, state_size=8, num_layers=2, mode="lstm",
                       name="lstm")
        return mx.sym.Group([loss, r[0], r[2]])

    launched = []
    monkeypatch.setattr(_build, "launch",
                        lambda *a, **k: launched.append(a[1]))
    shapes = dict(x=(2, 8, 8), label=(32,), lstm_parameters=(RNN_P,),
                  lstm_state=(2, 2, 8), lstm_state_cell=(2, 2, 8))
    got = build(tmx, net).infer_shape(**shapes)
    assert got[1][1:] == [(8, 2, 8), (2, 2, 8)], got
    assert got == build(jmx, net).infer_shape(**shapes)
    assert launched == []


def test_monitor_sees_the_executor_outputs():
    fn, shapes = GRAPHS["mlp"]
    jex, tex, _ = bind_both(fn, shapes)
    jmon, tmon = jmx.monitor.Monitor(1), tmx.monitor.Monitor(1)
    jmon.install(jex)
    tmon.install(tex)
    for mon, ex in ((jmon, jex), (tmon, tex)):
        mon.tic()
        ex.forward()
    jres, tres = jmon.toc(), tmon.toc()
    assert [r[1] for r in tres] == [r[1] for r in jres] == ["softmax_output"]
    assert float(tres[0][2]) == pytest.approx(float(jres[0][2]), rel=1e-5)


class _FopNet:
    """A block whose ``hybrid_forward`` is written in F-ops, built on
    either package's ``gluon``."""

    @staticmethod
    def build(g):
        class Net(g.HybridBlock):
            def __init__(self, **kwargs):
                super().__init__(**kwargs)
                with self.name_scope():
                    self.weight = self.params.get("weight", shape=(6, 5))
                    self.bias = self.params.get("bias", shape=(6,))

            def hybrid_forward(self, F, x, weight, bias):
                h = F.FullyConnected(x, weight, bias, num_hidden=6)
                return F.softmax(F.Activation(h, act_type="tanh"))

        return Net(prefix="fopnet_")


def test_export_is_imported_by_the_jax_symbol_block_and_back(tmp_path):
    rs = np.random.RandomState(5)
    w = rs.randn(6, 5).astype(np.float32)
    b = rs.randn(6).astype(np.float32)
    x = rs.randn(3, 5).astype(np.float32)
    with tmx.cpu():
        tnet = _FopNet.build(gluon)
        tnet.initialize()
        tnet.weight.set_data(w)
        tnet.bias.set_data(b)
        want = tnet(nd.array(x)).asnumpy()
        sym_file, params_file = tnet.export(str(tmp_path / "port"))
    jblock = jmx.gluon.SymbolBlock.imports(sym_file, ["data"], params_file)
    close(jblock(jmx.nd.array(x)).asnumpy(), want, 1e-5, "jax import")
    # the JAX package's export, imported by the port
    jnet = _FopNet.build(jmx.gluon)
    jnet.initialize()
    jnet.weight.set_data(jmx.nd.array(w))
    jnet.bias.set_data(jmx.nd.array(b))
    jfiles = jnet.export(str(tmp_path / "jax"))
    with tmx.cpu():
        tblock = gluon.SymbolBlock.imports(jfiles[0], ["data"], jfiles[1])
        got = tblock(nd.array(x))
        tblock.hybridize()
        hyb = tblock(nd.array(x))
    close(got.asnumpy(), want, 1e-5, "port import")
    np.testing.assert_array_equal(hyb.asnumpy(), got.asnumpy())
    assert sorted(tblock.collect_params()) == ["fopnet_bias", "fopnet_weight"]


def test_export_of_a_torch_layer_raises_naming_it(tmp_path):
    with tmx.cpu():
        net = nn.HybridSequential(prefix="seq_")
        with net.name_scope():
            net.add(nn.Dense(4, in_units=3))
        net.initialize()
    with pytest.raises(MXNetError, match="Dense 'dense0' has no "
                                         "symbolic form"):
        net.export(str(tmp_path / "dense"))
    assert not os.path.exists(str(tmp_path / "dense-symbol.json"))
