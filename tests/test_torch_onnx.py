"""ONNX export/import (``mx.contrib.onnx``) against the JAX package, on
the CPU.

The same graphs and numpy-seeded weights go through both packages'
``export_model``:

- each file of ``tests/test_onnx.py``'s cases (the nine model-zoo
  families, the five RNN modes, the MLP, the convnet with BatchNorm and
  the clip) equals the JAX package's byte for byte once its
  ``producer_name`` reads the same (the port's is
  ``"mxnet_tpu_torch"``);
- each package imports the other's file: the JAX package's import of
  the port's file is its import of its own (symbol JSON and arrays),
  and the port's import of the JAX file, bound with every array given,
  is within 1e-5 of scale of the model it was exported from (float32:
  the imported graph runs the same ops, a Dense's flatten split into
  ``Flatten`` + ``FullyConnected(flatten=False)``). The vision
  families' forwards against the JAX models are in
  ``tests/test_torch_vision_zoo.py``; the RNN and small graphs' here,
  through the JAX executor, within 1e-5 of scale;
- a 2-layer LSTM LM round-trips bit for bit, each ONNX ``LSTM`` node
  one 1-layer ``RNN`` that runs the plain version of K6a once;
- the hand-written wire codec reads and writes the bytes
  ``google.protobuf`` does for the same messages (this sandbox has it;
  the port never imports it), packed or not, and skips unknown fields;
- the importer keeps an initializer that another node still reads
  after an RNN node packed it (the JAX importer drops it).

The scale of an output is its largest magnitude.
"""
import json

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx
from mxnet_tpu.contrib import onnx as jonnx
from mxnet_tpu_torch.contrib import onnx as tonnx
from mxnet_tpu_torch.contrib.onnx import pb as tpb
from torch_zoo_cases import zoo_pair

torch.set_num_threads(1)


def close(got, want, tol, what=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-30)
    gap = float(np.abs(got - want).max())
    assert gap <= tol * scale, f"{what}: {gap} > {tol} x {scale}"


def same_file(port_path, jax_path):
    """The two files, byte for byte, once the producer names agree."""
    m = tpb.ModelProto()
    m.ParseFromString(open(port_path, "rb").read())
    assert m.producer_name == "mxnet_tpu_torch"
    m.producer_name = "mxnet_tpu"
    assert m.SerializeToString() == open(jax_path, "rb").read()


def jax_run(sym, feeds):
    ex = sym.bind(jmx.cpu(0), {k: jmx.nd.array(v) for k, v in feeds.items()})
    return [o.asnumpy() for o in ex.forward()]


def port_run(sym, feeds):
    with tmx.cpu():
        ex = sym.bind(tmx.cpu(), {k: tmx.nd.array(v)
                                  for k, v in feeds.items()})
        return [o.asnumpy() for o in ex.forward()]


def _port_import(path):
    with tmx.cpu():
        return tonnx.import_model(path)


def host(params):
    return {k: v.asnumpy() for k, v in params.items()}


def both_ways(tmp_path, jsym, tsym, params, shapes, name):
    """Export ``params`` (numpy) with both packages and check the bytes;
    each package imports the other's file (fresh name counters): the
    two imports give one graph, letter for letter, and the same arrays.
    Returns the port's import of the JAX file and the JAX package's of
    the port's, each (symbol, arg_params, aux_params)."""
    tf = str(tmp_path / f"{name}-port.onnx")
    jf = str(tmp_path / f"{name}-jax.onnx")
    jonnx.export_model(jsym, {k: jmx.nd.array(v) for k, v in params.items()},
                       input_shapes=shapes, onnx_file_path=jf)
    with tmx.cpu():
        tonnx.export_model(tsym, {k: tmx.nd.array(v)
                                  for k, v in params.items()},
                           input_shapes=shapes, onnx_file_path=tf)
    same_file(tf, jf)
    with tmx.name.NameManager():
        port = _port_import(jf)
    with jmx.name.NameManager():
        jax = jonnx.import_model(tf)
    assert port[0].tojson() == jax[0].tojson()
    for mine, theirs in zip(port[1:], jax[1:]):
        assert list(mine) == list(theirs)
        for k in mine:
            np.testing.assert_array_equal(mine[k].asnumpy(),
                                          theirs[k].asnumpy())
    return port, jax


def graphs(build):
    """The same graph built by both packages, with fresh names."""
    with jmx.name.NameManager():
        j = build(jmx)
    with tmx.name.NameManager():
        t = build(tmx)
    return j, t


RS = np.random.RandomState(3)


def _mlp(mx):
    data = mx.sym.var("data")
    net = mx.sym.FullyConnected(data, num_hidden=8, name="fc1")
    net = mx.sym.Activation(net, act_type="relu")
    net = mx.sym.FullyConnected(net, num_hidden=3, name="fc2")
    return mx.sym.softmax(net)


def _convnet(mx):
    data = mx.sym.var("data")
    net = mx.sym.Convolution(data, kernel=(3, 3), num_filter=4, pad=(1, 1),
                             name="conv0")
    net = mx.sym.BatchNorm(net, name="bn", fix_gamma=False,
                           use_global_stats=True)
    net = mx.sym.Activation(net, act_type="relu")
    net = mx.sym.Pooling(net, kernel=(2, 2), stride=(2, 2), pool_type="max")
    net = mx.sym.Flatten(net)
    return mx.sym.FullyConnected(net, num_hidden=5, name="fc0")


def _clip(mx):
    return mx.sym.clip(mx.sym.var("data"), a_min=-0.5, a_max=0.5)


SMALL = {
    "mlp": (_mlp, (4, 6), {"fc1_weight": (8, 6), "fc1_bias": (8,),
                           "fc2_weight": (3, 8), "fc2_bias": (3,)}),
    "convnet": (_convnet, (2, 2, 8, 8), {
        "conv0_weight": (4, 2, 3, 3), "conv0_bias": (4,),
        "bn_gamma": (4,), "bn_beta": (4,), "bn_moving_mean": (4,),
        "bn_moving_var": (4,), "fc0_weight": (5, 64), "fc0_bias": (5,)}),
    "clip": (_clip, (2, 3), {}),
}


def _weights(rs, shapes):
    out = {}
    for k, s in shapes.items():
        w = rs.randn(*s).astype(np.float32)
        if k.endswith(("var", "gamma")):
            w = np.abs(w) + 0.5
        out[k] = w
    return out


@pytest.mark.parametrize("case", sorted(SMALL))
def test_small_graphs_equal_the_jax_files_and_import_both_ways(case,
                                                               tmp_path):
    build, shape, wshapes = SMALL[case]
    jsym, tsym = graphs(build)
    rs = np.random.RandomState(7)
    params = _weights(rs, wshapes)
    x = (rs.randn(*shape) * 2).astype(np.float32)
    (ts, ta, tx), (js, ja, jx) = both_ways(tmp_path, jsym, tsym, params,
                                           {"data": shape}, case)
    want = port_run(tsym, {"data": x, **params})[0]
    close(jax_run(jsym, {"data": x, **params})[0], want, 1e-5, "original")
    got = port_run(ts, {"data": x, **host(ta), **host(tx)})[0]
    close(got, want, 1e-5, "port import")
    close(jax_run(js, {"data": x, **host(ja), **host(jx)})[0], want, 1e-5,
          "jax import")
    if case == "clip":
        assert not ta               # the bounds are no parameters
    if case == "convnet":
        assert sorted(tx) == ["bn_moving_mean", "bn_moving_var"]


@pytest.mark.parametrize("mode,bidir,layers",
                         [("lstm", False, 1), ("lstm", True, 2),
                          ("gru", False, 2), ("rnn_tanh", True, 1),
                          ("rnn_relu", False, 1)])
def test_rnn_modes_equal_the_jax_files_and_import_both_ways(mode, bidir,
                                                            layers,
                                                            tmp_path):
    from mxnet_tpu_torch.ndarray.op_impl_rnn import rnn_param_size

    T, N, I, H = 4, 3, 6, 5
    D = 2 if bidir else 1
    n_out = 3 if mode == "lstm" else 2

    def build(mx):
        args = [mx.sym.var("data"), mx.sym.var("par"), mx.sym.var("h0")]
        if mode == "lstm":
            args.append(mx.sym.var("c0"))
        s = mx.sym.RNN(*args, state_size=H, num_layers=layers,
                       bidirectional=bidir, mode=mode, state_outputs=True)
        return mx.sym.Group([s[i] for i in range(n_out)])

    jsym, tsym = graphs(build)
    rs = np.random.RandomState(5)
    feeds = {"data": rs.randn(T, N, I).astype(np.float32),
             "h0": rs.randn(layers * D, N, H).astype(np.float32) * 0.3}
    if mode == "lstm":
        feeds["c0"] = rs.randn(layers * D, N, H).astype(np.float32) * 0.3
    size = rnn_param_size(layers, I, H, bidir, mode)
    params = {"par": rs.randn(size).astype(np.float32) * 0.2}
    (ts, ta, _), (js, ja, _) = both_ways(tmp_path, jsym, tsym, params,
                                         {"data": (T, N, I)}, "rnn")
    want = port_run(tsym, {**feeds, **params})
    got = port_run(ts, {**feeds, **host(ta)})
    jgot = jax_run(js, {**feeds, **host(ja)})
    assert len(got) == len(jgot) == n_out
    for w, g, j in zip(want, got, jgot):
        close(g, w, 1e-5, f"{mode} port import")
        close(j, w, 1e-5, f"{mode} jax import")


# tests/test_onnx.py's families and input sizes (AlexNet at 64, where
# its first Dense is 256 wide instead of 9216)
ZOO = [("resnet18_v1", 32), ("resnet18_v2", 32), ("vgg11", 32),
       ("alexnet", 64), ("densenet121", 224), ("inception_v3", 299),
       ("squeezenet1_0", 64), ("mobilenet0_5", 32), ("mobilenet_v2_0_5", 32)]


@pytest.mark.parametrize("fam,size", ZOO, ids=[f for f, _ in ZOO])
def test_model_zoo_files_equal_the_jax_files_and_import_both_ways(
        fam, size, tmp_path):
    jnet, tnet, x, weights = zoo_pair(fam, size)
    with jmx.autograd.predict_mode():
        jsym = jnet(jmx.sym.var("data"))
    with tmx.cpu():
        tsym = tnet(tmx.sym.var("data"))
        want = tnet(torch.tensor(x)).numpy()
    assert tsym.tojson() == jsym.tojson()
    params = {jnet.prefix + k: w for k, w in weights.items()}
    assert list(params) == list(jnet.collect_params())
    (ts, ta, tx), _ = both_ways(tmp_path, jsym, tsym, params,
                                {"data": (1, 3, size, size)}, fam)
    got = port_run(ts, {"data": x, **host(ta), **host(tx)})[0]
    close(got, want, 1e-5, f"{fam} port import")


def _lm(mx, V, E, H, L):
    """The word LM's inference graph: Embedding -> 2-layer LSTM ->
    Reshape -> FullyConnected -> softmax, the final states as
    outputs."""
    e = mx.sym.Embedding(mx.sym.var("data"), input_dim=V, output_dim=E,
                         name="embed")
    r = mx.sym.RNN(e, mx.sym.var("lstm_parameters"), mx.sym.var("lstm_state"),
                   mx.sym.var("lstm_state_cell"), state_size=H,
                   num_layers=L, mode="lstm", state_outputs=True,
                   name="lstm")
    flat = mx.sym.Reshape(r[0], shape=(-1, H), name="flat")
    fc = mx.sym.FullyConnected(flat, num_hidden=V, name="decoder")
    return mx.sym.Group([mx.sym.softmax(fc, name="softmax"), r[1], r[2]])


def test_lstm_lm_round_trips_bit_for_bit_through_the_plain_k6a(
        tmp_path, monkeypatch):
    from mxnet_tpu_torch.ndarray.op_impl_rnn import rnn_param_size
    from mxnet_tpu_torch.ops import lstm

    V, E, H, L, T, N = 50, 8, 6, 2, 5, 3
    jsym, tsym = graphs(lambda mx: _lm(mx, V, E, H, L))
    rs = np.random.RandomState(11)
    params = {"embed_weight": rs.randn(V, E).astype(np.float32),
              "lstm_parameters": rs.randn(rnn_param_size(
                  L, E, H, False, "lstm")).astype(np.float32) * 0.2,
              "decoder_weight": rs.randn(V, H).astype(np.float32),
              "decoder_bias": rs.randn(V).astype(np.float32)}
    feeds = {"data": rs.randint(0, V, (T, N)).astype(np.float32),
             "lstm_state": rs.randn(L, N, H).astype(np.float32) * 0.3,
             "lstm_state_cell": rs.randn(L, N, H).astype(np.float32) * 0.3}
    (ts, ta, _), (js, ja, _) = both_ways(tmp_path, jsym, tsym, params,
                                         {"data": (T, N)}, "lm")
    m = tpb.ModelProto()
    m.ParseFromString(open(str(tmp_path / "lm-port.onnx"), "rb").read())
    assert [n.op_type for n in m.graph.node].count("LSTM") == L
    want = port_run(tsym, {**feeds, **params})
    # the packed vector rides along in the file, unread by any node
    assert "lstm_parameters" in ta and \
        "lstm_parameters" not in ts.list_arguments()
    calls = []
    plain = lstm.lstm_forward_reference
    monkeypatch.setattr(lstm, "lstm_forward_reference",
                        lambda *a, **k: calls.append(1) or plain(*a, **k))
    args = ts.list_arguments()
    got = port_run(ts, {k: feeds[k] if k in feeds else ta[k].asnumpy()
                        for k in args})
    assert len(calls) == L          # one plain K6a call a layer
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g, w)
    jgot = jax_run(js, {**feeds, **{k: v.asnumpy() for k, v in ja.items()
                                    if k in js.list_arguments()}})
    for w, j in zip(want, jgot):
        close(j, w, 1e-5, "jax import of the LM")


def test_codec_writes_and_reads_what_protobuf_does():
    from mxnet_tpu.contrib.onnx import onnx_minimal_pb2 as jpb

    def fill(pb):
        m = pb.ModelProto()
        m.ir_version = 8
        m.producer_name = "p"
        m.model_version = -3                    # a negative int64
        op = m.opset_import.add()
        op.version = 13
        g = m.graph
        g.name = "g"
        n = pb.NodeProto()
        n.op_type, n.name = "Conv", "c"
        n.input.extend(["x", "", "w"])
        n.output.extend(["y"])
        for name, kind, vals in (("f", "f", -0.0), ("i", "i", -7)):
            a = pb.AttributeProto()
            a.name = name
            a.type = pb.AttributeProto.FLOAT if kind == "f" \
                else pb.AttributeProto.INT
            setattr(a, kind, vals)
            n.attribute.append(a)
        a = pb.AttributeProto()
        a.name, a.type = "ints", pb.AttributeProto.INTS
        a.ints.extend([1, -2, 300])
        n.attribute.append(a)
        a = pb.AttributeProto()
        a.name, a.type = "floats", pb.AttributeProto.FLOATS
        a.floats.extend([0.5, -1.25])
        n.attribute.append(a)
        a = pb.AttributeProto()
        a.name, a.type = "strings", pb.AttributeProto.STRINGS
        a.strings.extend([b"Tanh", b""])
        n.attribute.append(a)
        g.node.append(n)
        t = pb.TensorProto()
        t.name, t.data_type = "w", pb.TensorProto.FLOAT
        t.dims.extend([2, 0, 3])
        t.float_data.extend([1.0, 2.0])
        t.int64_data.extend([-1, 2 ** 40])
        t.raw_data = bytes(range(7))
        g.initializer.append(t)
        vi = g.input.add()
        vi.name = "x"
        vi.type.tensor_type.elem_type = pb.TensorProto.FLOAT
        for d in (1, 0, 5):
            vi.type.tensor_type.shape.dim.add().dim_value = d
        vo = g.output.add()
        vo.name = "y"
        return m.SerializeToString()

    want = fill(jpb)
    assert fill(tpb) == want
    m = tpb.ModelProto()
    m.ParseFromString(want)
    assert m.SerializeToString() == want
    assert m.model_version == -3 and m.graph.node[0].attribute[2].ints == \
        [1, -2, 300]
    assert m.graph.initializer[0].int64_data == [-1, 2 ** 40]
    assert [d.dim_value for d in m.graph.input[0].type.tensor_type.shape.dim] \
        == [1, 0, 5]
    # unpacked repeated scalars and unknown fields (a field 15 varint, a
    # field 16 string) are read as protobuf reads them
    t = jpb.TensorProto()
    t.dims.extend([4, 5])
    t.name = "u"
    body = b"\x08\x04\x08\x05" + b"\x78\x01" + b"\x82\x01\x02hi" + \
        b"\x42\x01u"
    assert t.SerializeToString() != body
    t2 = jpb.TensorProto()
    t2.ParseFromString(body)
    mine = tpb.TensorProto()
    mine.ParseFromString(body)
    assert list(mine.dims) == list(t2.dims) == [4, 5]
    assert mine.name == t2.name == "u"


def test_rnn_import_keeps_an_initializer_another_node_reads(tmp_path):
    """An LSTM node's W is also a graph output (through ``Identity``):
    the JAX importer pops W from ``arg_params`` though the graph still
    reads it, so binding needs it fed by hand; the port keeps it."""
    H, I = 3, 2
    rs = np.random.RandomState(2)
    m = tpb.ModelProto()
    m.ir_version = 8
    m.opset_import.add().version = 13
    g = m.graph
    g.name = "shared"
    for name, arr in (("W", rs.randn(1, 4 * H, I)), ("R", rs.randn(1, 4 * H, H)),
                      ("B", rs.randn(1, 8 * H))):
        g.initializer.append(tonnx._np_tensor(name, arr.astype(np.float32)))
    for name in ("x", "h0", "c0"):
        g.input.add().name = name
    n = tpb.NodeProto()
    n.op_type, n.name = "LSTM", "lstm"
    n.input.extend(["x", "W", "R", "B", "", "h0", "c0"])
    n.output.extend(["Y", "Yh"])
    n.attribute.append(tonnx._attr("hidden_size", H))
    g.node.append(n)
    n = tpb.NodeProto()
    n.op_type, n.name = "Identity", "id"
    n.input.extend(["W"])
    n.output.extend(["Wout"])
    g.node.append(n)
    g.output.add().name = "Yh"
    g.output.add().name = "Wout"
    path = str(tmp_path / "shared.onnx")
    open(path, "wb").write(m.SerializeToString())

    js, ja, _ = jonnx.import_model(path)
    assert "W" in js.list_arguments() and "W" not in ja
    ts, ta, _ = _port_import(path)
    assert "W" in ts.list_arguments() and "W" in ta
    feeds = {"x": rs.randn(4, 2, I).astype(np.float32),
             "h0": np.zeros((1, 2, H), np.float32),
             "c0": np.zeros((1, 2, H), np.float32)}
    got = port_run(ts, {**feeds, **host(ta)})
    want = jax_run(js, {**feeds, **host(ja), "W": ta["W"].asnumpy()})
    for g_, w_ in zip(got, want):
        close(g_, w_, 1e-5, "shared W")
    np.testing.assert_array_equal(got[1], ta["W"].asnumpy())


def test_import_puts_arrays_on_the_current_context(tmp_path):
    jsym, tsym = graphs(_mlp)
    params = _weights(np.random.RandomState(1), SMALL["mlp"][2])
    path = str(tmp_path / "mlp.onnx")
    with tmx.cpu():
        tonnx.export_model(tsym, {k: tmx.nd.array(v)
                                  for k, v in params.items()},
                           input_shapes={"data": (4, 6)},
                           onnx_file_path=path)
        _, args, _ = tonnx.import_model(path)
    assert all(a.context == tmx.cpu() for a in args.values())
    assert json.loads(tsym.tojson()) == json.loads(jsym.tojson())
