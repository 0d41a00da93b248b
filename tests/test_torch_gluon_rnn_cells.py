"""The port's Gluon recurrent cells (``gluon.rnn.rnn_cell``,
``gluon.contrib.rnn``) against the JAX package's, on the CPU.

Each cell is built in both packages with the same input width; the
port's takes the JAX cell's weights by structural name (the names of
``save_parameters``: ``i2h_weight``, ``0.i2h_weight``,
``2.base_cell.h2h_weight``, ``l_cell.i2h_bias``), and ``unroll`` runs
over the same numpy inputs in both layouts, with and without
``merge_outputs``. Outputs and states agree within 1e-5 (the same
float32 products and gates, summed in another order). The dropout and
zoneout cells draw their masks from torch's generator (the JAX package
from its key chain), so they are held by property.
"""
import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx
from mxnet_tpu import autograd as jag
from mxnet_tpu_torch import autograd as tag

torch.set_num_threads(1)

T, N, I, H = 4, 3, 5, 6
TOL = dict(rtol=1e-5, atol=1e-5)


def _build(mx, kind):
    r = mx.gluon.rnn
    if kind == "rnn_tanh":
        return r.RNNCell(H, input_size=I)
    if kind == "rnn_relu":
        return r.RNNCell(H, activation="relu", input_size=I)
    if kind == "lstm":
        return r.LSTMCell(H, input_size=I)
    if kind == "gru":
        return r.GRUCell(H, input_size=I)
    if kind == "sequential":
        seq = r.SequentialRNNCell()
        seq.add(r.LSTMCell(H, input_size=I))
        seq.add(r.DropoutCell(0.0))
        seq.add(r.ResidualCell(r.GRUCell(H, input_size=H)))
        return seq
    if kind == "bidirectional":
        return r.BidirectionalCell(r.GRUCell(H, input_size=I),
                                   r.LSTMCell(H, input_size=I))
    if kind == "zoneout0":
        return r.ZoneoutCell(r.LSTMCell(H, input_size=I))
    if kind == "vardrop0":
        return mx.gluon.contrib.rnn.VariationalDropoutCell(
            r.GRUCell(H, input_size=I))
    raise ValueError(kind)


def _pair(kind):
    """The JAX cell (initialized) and the port's holding its weights."""
    jmx.random.seed(3)
    jcell = _build(jmx, kind)
    jcell.initialize(init=jmx.initializer.Xavier())
    with tmx.cpu():
        tcell = _build(tmx, kind)
        tcell.initialize()
    jparams = jcell._collect_params_with_prefix()
    tparams = dict(tcell.named_parameters())
    assert set(tparams) == set(jparams)
    with torch.no_grad():
        for name, p in tparams.items():
            p.copy_(torch.from_numpy(jparams[name].data().asnumpy().copy()))
    return jcell, tcell


def _inputs(layout, seed=1):
    x = np.random.RandomState(seed).randn(T, N, I).astype(np.float32)
    return x if layout == "TNC" else x.swapaxes(0, 1).copy()


def _states(cell_info, seed=2):
    rng = np.random.RandomState(seed)
    return [(rng.randn(*info["shape"]) * 0.5).astype(np.float32)
            for info in cell_info]


KINDS = ["rnn_tanh", "rnn_relu", "lstm", "gru", "sequential",
         "bidirectional", "zoneout0", "vardrop0"]


@pytest.mark.parametrize("merge", [True, False])
@pytest.mark.parametrize("layout", ["NTC", "TNC"])
@pytest.mark.parametrize("kind", KINDS)
def test_cell_unroll_matches_jax(kind, layout, merge):
    jcell, tcell = _pair(kind)
    x = _inputs(layout)
    states = _states(tcell.state_info(N))
    jout, jst = jcell.unroll(T, jmx.nd.array(x),
                             [jmx.nd.array(s) for s in states],
                             layout=layout, merge_outputs=merge)
    with tmx.cpu():
        tout, tst = tcell.unroll(T, tmx.nd.array(x),
                                 [tmx.nd.array(s) for s in states],
                                 layout=layout, merge_outputs=merge)
    if merge:
        assert tuple(tout.shape) == tuple(jout.shape)
        np.testing.assert_allclose(tout.asnumpy(), jout.asnumpy(), **TOL)
    else:
        assert len(tout) == len(jout) == T
        for a, b in zip(tout, jout):
            np.testing.assert_allclose(a.asnumpy(), b.asnumpy(), **TOL)
    assert len(tst) == len(jst)
    for a, b in zip(tst, jst):
        np.testing.assert_allclose(a.asnumpy(), b.asnumpy(), **TOL)


@pytest.mark.parametrize("kind", ["lstm", "gru", "rnn_tanh"])
def test_cell_step_gradients_match_jax(kind):
    """One recorded unroll's gradients of the inputs and of the
    ``h2h_weight``; the cell hybridized gives the eager result."""
    jcell, tcell = _pair(kind)
    x = _inputs("NTC", 4)
    states = _states(tcell.state_info(N), 5)
    jx = jmx.nd.array(x)
    jx.attach_grad()
    with jag.record():
        jout, _ = jcell.unroll(T, jx, [jmx.nd.array(s) for s in states],
                               merge_outputs=True)
        (jout * jout).sum().backward()
    res = []
    for hybrid in (False, True):
        if hybrid:
            tcell.hybridize()
        tcell.zero_grad()
        with tmx.cpu():
            tx = tmx.nd.array(x)
            tx.attach_grad()
            with tag.record():
                tout, _ = tcell.unroll(T, tx,
                                       [tmx.nd.array(s) for s in states],
                                       merge_outputs=True)
                (tout * tout).sum().backward()
        res.append((tout.asnumpy(), tx.grad.asnumpy(),
                    tcell.h2h_weight._tensor.grad.numpy().copy()))
    jg = jcell.h2h_weight.grad().asnumpy()
    for out, gx, gw in res:
        np.testing.assert_allclose(out, jout.asnumpy(), **TOL)
        np.testing.assert_allclose(gx, jx.grad.asnumpy(), rtol=1e-4,
                                   atol=1e-5)
        np.testing.assert_allclose(gw, jg, rtol=1e-4, atol=1e-5)
    assert np.array_equal(res[0][0], res[1][0])


def test_cell_names_and_deferred_width_match_jax():
    """Prefixes from the JAX aliases (``lstm``, ``gru``, ``rnn``);
    a cell without ``input_size`` takes its width at the first step."""
    with tmx.cpu():
        assert tmx.gluon.rnn.LSTMCell(2).prefix.startswith("lstm")
        assert tmx.gluon.rnn.GRUCell(2).prefix.startswith("gru")
        assert tmx.gluon.rnn.RNNCell(2).prefix.startswith("rnn")
        z = tmx.gluon.rnn.ZoneoutCell(tmx.gluon.rnn.GRUCell(2,
                                                            prefix="g_"))
        assert z.prefix == "g_zoneout"
        cell = tmx.gluon.rnn.GRUCell(H)
        cell.initialize()
        out, st = cell.unroll(T, tmx.nd.array(_inputs("NTC")),
                              merge_outputs=True)
    assert out.shape == (N, T, H) and cell.i2h_weight.shape == (3 * H, I)
    assert len(st) == 1 and st[0].shape == (N, H)


def test_modifier_and_bidirectional_rules():
    r = tmx.gluon.rnn
    with tmx.cpu():
        base = r.LSTMCell(H, input_size=I)
        r.ResidualCell(base)
        with pytest.raises(tmx.MXNetError, match="already modified"):
            r.ZoneoutCell(base)
        with pytest.raises(tmx.MXNetError, match="modifier"):
            base.begin_state(N)
        bi = r.BidirectionalCell(r.GRUCell(H, input_size=I),
                                 r.GRUCell(H, input_size=I))
    with pytest.raises(tmx.MXNetError, match="unroll"):
        bi(torch.zeros(N, I), [])


def test_dropout_cells_by_property():
    """In training DropoutCell zeroes about ``rate`` of the input and
    scales the rest by ``1 / (1 - rate)``; in predict mode it is the
    identity. ZoneoutCell's every output unit is the new output or the
    previous one. VariationalDropoutCell keeps one input mask for
    every step of an unroll (``zoneout_states`` is the same rule on the
    states)."""
    r = tmx.gluon.rnn
    x = torch.ones(200, 50)
    with tmx.cpu():
        drop = r.DropoutCell(0.3)
        with tag.record():
            y, _ = drop(x, [])
        kept = (y != 0).float().mean().item()
        assert abs(kept - 0.7) < 0.02
        assert torch.allclose(y[y != 0], torch.full_like(y[y != 0],
                                                         1 / 0.7))
        y, _ = drop(x, [])
        assert torch.equal(y, x)

        base = r.GRUCell(8, input_size=4)
        zone = r.ZoneoutCell(base, zoneout_outputs=0.5)
        zone.initialize()
        xs = torch.randn(64, 3, 4)
        with tag.record():
            outs, _ = zone.unroll(3, xs, layout="NTC", merge_outputs=False)
        prev = torch.zeros_like(outs[0])
        h = torch.zeros(64, 8)
        for t in range(3):
            new, _ = base.hybrid_forward(
                tmx.nd, xs[:, t], [h], **{
                    k: getattr(base, k)._tensor for k in
                    ("i2h_weight", "h2h_weight", "i2h_bias", "h2h_bias")})
            o = outs[t].detach()
            assert torch.all((o == new.detach()) | (o == prev))
            assert (o == new.detach()).any() and (o == prev).any()
            prev = o
            h = new.detach()        # the states are not zoned out here

        var = tmx.gluon.contrib.rnn.VariationalDropoutCell(
            r.RNNCell(5, input_size=6, activation="relu"),
            drop_inputs=0.5)
        var.initialize()
        with tag.record():
            var.unroll(4, torch.ones(10, 4, 6), layout="NTC")
        mask = var.drop_inputs_mask
        assert mask is not None and set(mask.unique().tolist()) <= {0.0,
                                                                    2.0}
        with tag.record():
            var.unroll(4, torch.ones(10, 4, 6), layout="NTC")
        assert var.drop_inputs_mask is not mask     # drawn again
