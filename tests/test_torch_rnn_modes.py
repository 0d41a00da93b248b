"""The ``RNN`` op's GRU and vanilla modes and the fused ``gluon.rnn.GRU``
and ``gluon.rnn.RNN`` layers against the JAX package's, on the CPU.

The port runs each layer and direction through torch's one-layer RNN
(``torch._VF``), the JAX op its ``lax.scan`` cell: the same float32
equations summed in another order. Tolerances: outputs and states
1e-5; gradients through two bidirectional layers and the packing 1e-4
(as tests/test_torch_rnn.py holds the LSTM mode). The layers carry the
JAX layer's weights by name (``load_gluon_params``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu import autograd as jag
from mxnet_tpu.ndarray.op_impl_rnn import rnn as jax_rnn
from mxnet_tpu_torch import autograd as ag
from mxnet_tpu_torch.gluon import rnn
from mxnet_tpu_torch.ndarray import op_impl_rnn

torch.set_num_threads(1)

T, N, I, H, L = 5, 3, 6, 4, 2
MODES = ["gru", "rnn_tanh", "rnn_relu"]


def _packed_case(mode, bidirectional, seed=2):
    rng = np.random.RandomState(seed)
    d = 2 if bidirectional else 1
    size = op_impl_rnn.rnn_param_size(L, I, H, bidirectional, mode)
    return (rng.randn(T, N, I).astype(np.float32),
            (rng.randn(size) * 0.4).astype(np.float32),
            (rng.randn(L * d, N, H) * 0.5).astype(np.float32),
            rng.randn(T, N, H * d).astype(np.float32))


@pytest.mark.parametrize("bidirectional", [False, True])
@pytest.mark.parametrize("mode", MODES)
def test_packed_rnn_op_modes_match_jax(mode, bidirectional):
    """Forward (output, final states) and the gradients of every input
    (data, packed parameters, initial state)."""
    x, params, h0, wo = _packed_case(mode, bidirectional)
    kw = dict(state_size=H, num_layers=L, bidirectional=bidirectional,
              mode=mode)
    want = [np.asarray(a) for a in jax_rnn(
        *(jnp.asarray(a) for a in (x, params, h0)), **kw)]
    leaves = [torch.from_numpy(a).requires_grad_() for a in (x, params, h0)]
    got = op_impl_rnn.rnn(*leaves, **kw)
    assert len(got) == 2
    for name, g, w in zip(("out", "h"), got, want):
        np.testing.assert_allclose(g.detach().numpy(), w, rtol=1e-5,
                                   atol=1e-5, err_msg=name)

    def jloss(*a):
        out, h = jax_rnn(*a, **kw)
        return (out * wo).sum() + (h * h).sum()
    jgrads = jax.grad(jloss, argnums=(0, 1, 2))(
        *(jnp.asarray(a) for a in (x, params, h0)))
    out, h = got
    ((out * torch.from_numpy(wo)).sum() + (h * h).sum()).backward()
    for name, leaf, jg in zip(("dx", "dparams", "dh0"), leaves, jgrads):
        np.testing.assert_allclose(leaf.grad.numpy(), np.asarray(jg),
                                   rtol=1e-4, atol=1e-4, err_msg=name)


def test_registry_rnn_op_returns_two_outputs_for_gru():
    import mxnet_tpu_torch as tmx
    x, params, h0, _ = _packed_case("gru", False)
    with tmx.cpu():
        out = tmx.nd.RNN(tmx.nd.array(x), tmx.nd.array(params),
                         tmx.nd.array(h0), state_size=H, num_layers=L,
                         mode="gru", state_outputs=True)
    assert len(out) == 2 and out[0].shape == (T, N, H)
    sym = tmx.sym.RNN(tmx.sym.var("x"), state_size=H, num_layers=L,
                      mode="gru", name="g")
    assert sym.num_outputs == 2
    assert "g_state_cell" not in sym.list_arguments()


def _carried(cls, kind, layout, bidirectional, **kw):
    """A JAX layer (shapes resolved by one call) and the port's layer
    holding its weights by name."""
    mx.random.seed(5)
    jnet = getattr(mx.gluon.rnn, cls)(H, num_layers=L, layout=layout,
                                      bidirectional=bidirectional, **kw)
    jnet.initialize(init=mx.initializer.Xavier())
    shape = (T, N, I) if layout == "TNC" else (N, T, I)
    with jag.predict_mode():
        jnet(mx.nd.zeros(shape))
    pre = jnet.prefix
    params = {k[len(pre):]: p.data().asnumpy()
              for k, p in jnet.collect_params().items()}
    net = getattr(rnn, cls)(H, num_layers=L, layout=layout,
                            bidirectional=bidirectional, input_size=I,
                            device="cpu", **kw)
    assert set(dict(net.named_parameters())) == set(params)
    net.load_gluon_params(params)
    return jnet, net, shape


@pytest.mark.parametrize("cls,kw", [("GRU", {}),
                                    ("RNN", {"activation": "tanh"}),
                                    ("RNN", {"activation": "relu"})])
@pytest.mark.parametrize("layout,with_states", [("TNC", False),
                                                ("NTC", True)])
def test_gluon_gru_and_rnn_match_jax_with_carried_weights(cls, kw, layout,
                                                          with_states):
    bidirectional = layout == "NTC"
    jnet, net, shape = _carried(cls, None, layout, bidirectional, **kw)
    rng = np.random.RandomState(6)
    x = rng.randn(*shape).astype(np.float32)
    h0 = (rng.randn(L * (1 + bidirectional), N, H) * 0.5).astype(np.float32)
    wo = rng.randn(*jnet(mx.nd.array(x)).shape).astype(np.float32)
    jx = mx.nd.array(x)
    jx.attach_grad()
    tx = torch.from_numpy(x).requires_grad_()
    with jag.record():
        jres = jnet(jx, [mx.nd.array(h0)]) if with_states else jnet(jx)
        jout = jres[0] if with_states else jres
        (jout * mx.nd.array(wo)).sum().backward()
    with ag.record():
        res = net(tx, [torch.from_numpy(h0)]) if with_states else net(tx)
        out = res[0] if with_states else res
        (out * torch.from_numpy(wo)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), jout.asnumpy(),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tx.grad.numpy(), jx.grad.asnumpy(),
                               rtol=1e-4, atol=1e-4)
    if with_states:
        assert len(res[1]) == len(jres[1]) == 1
        np.testing.assert_allclose(res[1][0].detach().numpy(),
                                   jres[1][0].asnumpy(), rtol=1e-5,
                                   atol=1e-5)
    jg = jnet.collect_params()[jnet.prefix + "l0_h2h_weight"].grad()
    np.testing.assert_allclose(net.l0_h2h_weight.grad.numpy(),
                               jg.asnumpy(), rtol=1e-4, atol=1e-4)


def test_gluon_gru_layer_contract():
    """Deferred input width, begin_state, hybridize (CPU: the eager
    body), the float64 path and dropout between layers in training."""
    lazy = rnn.GRU(H, num_layers=2, dropout=0.5, device="cpu")
    lazy.initialize()
    x = torch.randn(T, N, I)
    assert lazy(x).shape == (T, N, H)
    assert lazy.l0_i2h_weight.shape == (3 * H, I)
    st = lazy.begin_state(N)
    assert len(st) == 1 and st[0].shape == (2, N, H)
    with ag.predict_mode():
        eager = lazy(x)
    lazy.hybridize()
    with ag.predict_mode():
        assert torch.equal(lazy(x), eager)
    torch.manual_seed(0)
    with ag.record():
        trained = lazy(x)
    assert not torch.allclose(trained, eager)
    d = rnn.RNN(H, activation="tanh", device="cpu", input_size=I,
                dtype="float64")
    d.initialize()
    assert d(x.double()).dtype == torch.float64
