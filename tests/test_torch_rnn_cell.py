"""The port's legacy symbolic RNN cells (``mx.rnn``) against the JAX
package's, on the CPU: each cell's ``unroll`` in both layouts, its
graph (the same nnvm JSON), its outputs and final states, and the
gradients of every argument for a numpy-seeded head gradient, through
each package's executor. Tolerances: ``test_torch_rnn.py``'s, outputs
within 1e-5 and gradients within 1e-4 of the JAX value's largest
magnitude.
"""
import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import nd

torch.set_num_threads(1)

T, N, I, H = 4, 3, 5, 6


def make_cell(mx, kind):
    rnn = mx.rnn
    if kind == "rnn":
        return rnn.RNNCell(H, prefix="rnn_")
    if kind == "lstm":
        return rnn.LSTMCell(H, prefix="lstm_", forget_bias=1.0)
    if kind == "gru":
        return rnn.GRUCell(H, prefix="gru_")
    if kind == "sequential":
        cell = rnn.SequentialRNNCell()
        cell.add(rnn.LSTMCell(H, prefix="l0_"))
        cell.add(rnn.DropoutCell(0.0, prefix="d0_"))
        cell.add(rnn.GRUCell(H, prefix="l1_"))
        return cell
    if kind == "residual":
        return rnn.ResidualCell(rnn.RNNCell(I, prefix="res_"))
    if kind == "bidirectional":
        return rnn.BidirectionalCell(rnn.LSTMCell(H, prefix="fw_"),
                                     rnn.GRUCell(H, prefix="bw_"))
    raise ValueError(kind)


def graph(mx, kind, layout, merge):
    with mx.name.NameManager():
        cell = make_cell(mx, kind)
        outs, states = cell.unroll(T, mx.sym.var("data"), layout=layout,
                                   merge_outputs=merge)
        outs = [outs] if merge else list(outs)
        return mx.sym.Group(outs + list(states)), cell


def run(mx, sym, args, heads):
    ctx = {} if mx is jmx else {"ctx": tmx.cpu()}
    ex = sym.bind(mx.cpu(), {k: mx.nd.array(v, **ctx)
                             for k, v in args.items()})
    outs = [o.asnumpy() for o in ex.forward(is_train=True)]
    ex.backward([mx.nd.array(h, **ctx) for h in heads])
    return outs, {k: v.asnumpy() for k, v in ex.grad_dict.items()}


def close(got, want, tol, what=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-30)
    gap = float(np.abs(got - want).max())
    assert gap <= tol * scale, f"{what}: {gap} > {tol} x {scale}"


CASES = [(k, "NTC", True) for k in ("rnn", "lstm", "gru", "sequential",
                                    "residual", "bidirectional")] + \
    [(k, "TNC", True) for k in ("lstm", "gru", "bidirectional")] + \
    [("lstm", "NTC", False), ("residual", "TNC", False)]


@pytest.mark.parametrize("kind,layout,merge", CASES,
                         ids=[f"{k}-{lay}-{'merged' if m else 'steps'}"
                              for k, lay, m in CASES])
def test_unroll_equals_the_jax_package(kind, layout, merge):
    jsym, _ = graph(jmx, kind, layout, merge)
    tsym, tcell = graph(tmx, kind, layout, merge)
    assert tsym.tojson() == jsym.tojson()
    data_shape = (N, T, I) if layout == "NTC" else (T, N, I)
    arg_shapes, out_shapes, _ = tsym.infer_shape(data=data_shape)
    assert (arg_shapes, out_shapes) == \
        jsym.infer_shape(data=data_shape)[:2]
    rs = np.random.RandomState(0)
    args = {n: (0.5 * rs.randn(*s)).astype(np.float32)
            for n, s in zip(tsym.list_arguments(), arg_shapes)}
    heads = [rs.randn(*s).astype(np.float32) for s in out_shapes]
    jouts, jgrads = run(jmx, jsym, args, heads)
    touts, tgrads = run(tmx, tsym, args, heads)
    for i, (t, j) in enumerate(zip(touts, jouts)):
        close(t, j, 1e-5, f"output {i}")
    assert sorted(tgrads) == sorted(jgrads)
    for name, g in jgrads.items():
        close(tgrads[name], g, 1e-4, name)
    assert tcell.state_info == make_cell(jmx, kind).state_info


def test_begin_state_variables_and_the_lstm_bias_initializer():
    """``begin_state()`` variables fed explicitly; ``LSTMCell``'s
    ``h2h_bias`` carries ``LSTMBias``, which ``Module.init_params``
    applies over the global initializer."""
    with tmx.name.NameManager():
        cell = tmx.rnn.LSTMCell(H, prefix="lstm_", forget_bias=2.5)
        begin = cell.begin_state()
        outs, states = cell.unroll(T, tmx.sym.var("data"), begin_state=begin,
                                   merge_outputs=True)
        sym = tmx.sym.Group([outs] + states)
    names = sym.list_arguments()
    assert [b.name for b in begin] == ["lstm_begin_state_0_0",
                                       "lstm_begin_state_0_1"]
    mod = tmx.mod.Module(sym, data_names=["data"] + [b.name for b in begin],
                         label_names=[], context=tmx.cpu())
    mod.bind(data_shapes=[("data", (N, T, I)),
                          ("lstm_begin_state_0_0", (N, H)),
                          ("lstm_begin_state_0_1", (N, H))],
             for_training=False)
    mod.init_params(initializer=tmx.initializer.Uniform(0.1))
    args, _ = mod.get_params()
    bias = args["lstm_h2h_bias"].asnumpy()
    want = np.zeros(4 * H, np.float32)
    want[H:2 * H] = 2.5
    np.testing.assert_array_equal(bias, want)
    assert 0 < np.abs(args["lstm_i2h_weight"].asnumpy()).max() <= 0.1
    assert "lstm_begin_state_0_0" in names
    rs = np.random.RandomState(3)
    x = rs.randn(N, T, I).astype(np.float32)
    h0 = rs.randn(N, H).astype(np.float32)
    c0 = rs.randn(N, H).astype(np.float32)
    batch = tmx.io.DataBatch(data=[nd.array(v, ctx=tmx.cpu())
                                   for v in (x, h0, c0)])
    mod.forward(batch, is_train=False)
    got = mod.get_outputs()[1].asnumpy()
    jsym = tmx.sym.load_json(sym.tojson())
    assert jsym.tojson() == sym.tojson()
    # the JAX package with the same weights and states
    jargs = {k: jmx.nd.array(v.asnumpy()) for k, v in args.items()}
    jargs.update(data=jmx.nd.array(x), lstm_begin_state_0_0=jmx.nd.array(h0),
                 lstm_begin_state_0_1=jmx.nd.array(c0))
    want_h = jmx.sym.load_json(sym.tojson()).bind(jmx.cpu(), jargs) \
        .forward()[1].asnumpy()
    close(got, want_h, 1e-5, "final h")
