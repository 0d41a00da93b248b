"""The port's LSTM path above the kernels against the JAX package's, on
the CPU: the packed ``RNN`` op, ``gluon.rnn.LSTM``, the initializers,
``clip_global_norm`` and three steps of the word LM's training loop
(``mxnet_tpu_torch/examples/word_lm.py`` against ``example/word_lm.py``).

The port's LSTM kernels take their plain versions on CPU tensors. The
JAX op runs on its default ``lax.scan`` path and, with
``MXNET_TPU_FUSED_LSTM=1``, on its Pallas kernels in interpret mode.
Tolerances: the same float32 math summed in another order, 1e-5 on
outputs; gradients through two bidirectional layers and the packing
1e-4; the word LM (losses 1e-5 relative, weights after three SGD steps
2e-5) as the BERT trainer test holds them.
"""
import importlib.util
import math
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu import autograd as jag
from mxnet_tpu import gluon as jgluon
from mxnet_tpu.gluon.utils import clip_global_norm as jax_clip
from mxnet_tpu.ndarray.op_impl_rnn import rnn as jax_rnn
from mxnet_tpu_torch import autograd as ag
from mxnet_tpu_torch import gluon, initializer
from mxnet_tpu_torch.gluon import rnn
from mxnet_tpu_torch.gluon.utils import clip_global_norm
from mxnet_tpu_torch.ndarray import op_impl_rnn
from mxnet_tpu_torch.examples import word_lm

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parent.parent
T, N, I, H, L = 5, 4, 12, 8, 2


def _jax_example():
    spec = importlib.util.spec_from_file_location(
        "jax_word_lm_example", ROOT / "example" / "word_lm.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _packed_case(bidirectional, seed=4):
    rng = np.random.RandomState(seed)
    d = 2 if bidirectional else 1
    size = op_impl_rnn.rnn_param_size(L, I, H, bidirectional, "lstm")
    return (rng.randn(T, N, I).astype(np.float32),
            (rng.randn(size) * 0.3).astype(np.float32),
            (rng.randn(L * d, N, H) * 0.5).astype(np.float32),
            (rng.randn(L * d, N, H) * 0.5).astype(np.float32),
            rng.randn(T, N, H * d).astype(np.float32))


@pytest.mark.parametrize("bidirectional", [False, True])
@pytest.mark.parametrize("jax_path", ["scan", "fused_interpret"])
def test_packed_rnn_op_matches_jax(monkeypatch, bidirectional, jax_path):
    if jax_path == "fused_interpret":
        monkeypatch.setenv("MXNET_TPU_FUSED_LSTM", "1")
        monkeypatch.setenv("MXNET_TPU_PALLAS_INTERPRET", "1")
    else:
        monkeypatch.delenv("MXNET_TPU_FUSED_LSTM", raising=False)
    x, params, h0, c0, wo = _packed_case(bidirectional)
    kw = dict(state_size=H, num_layers=L, bidirectional=bidirectional,
              mode="lstm", lstm_state_clip_min=-0.9,
              lstm_state_clip_max=0.9)
    want = [np.asarray(a) for a in jax_rnn(
        *(jnp.asarray(a) for a in (x, params, h0, c0)), **kw)]
    leaves = [torch.from_numpy(a).requires_grad_()
              for a in (x, params, h0, c0)]
    got = op_impl_rnn.rnn(*leaves, **kw)
    for name, g, w in zip(("out", "h", "c"), got, want):
        np.testing.assert_allclose(g.detach().numpy(), w, rtol=1e-5,
                                   atol=1e-5, err_msg=name)
    if jax_path == "scan" and bidirectional:    # both directions' grads
        import jax

        def jloss(*a):
            out, h, c = jax_rnn(*a, **kw)
            return (out * wo).sum() + h.sum() + (c * c).sum()
        jgrads = jax.grad(jloss, argnums=(0, 1, 2, 3))(
            *(jnp.asarray(a) for a in (x, params, h0, c0)))
        out, h, c = got
        ((out * torch.from_numpy(wo)).sum() + h.sum() + (c * c).sum()
         ).backward()
        for name, leaf, jg in zip(("dx", "dparams", "dh0", "dc0"), leaves,
                                  jgrads):
            np.testing.assert_allclose(leaf.grad.numpy(), np.asarray(jg),
                                       rtol=1e-4, atol=1e-4, err_msg=name)


def test_pack_and_unpack_round_trip_and_modes_not_ported():
    x, params, h0, c0, _ = _packed_case(True)
    sets = op_impl_rnn._unpack_params(torch.from_numpy(params), L, I, H,
                                      True, "lstm")
    assert [tuple(t.shape) for t in sets[2]] == [(4 * H, 2 * H),
                                                 (4 * H, H), (4 * H,),
                                                 (4 * H,)]
    assert torch.equal(op_impl_rnn.pack_rnn_params(sets),
                       torch.from_numpy(params))
    for mode in ("gru", "rnn_tanh", "rnn_relu"):
        with pytest.raises(NotImplementedError, match="RNN remainders"):
            op_impl_rnn.rnn(*(torch.from_numpy(a) for a in (x, params, h0)),
                            state_size=H, num_layers=L, mode=mode)
    with pytest.raises(ValueError, match="packed RNN parameters"):
        op_impl_rnn.rnn(*(torch.from_numpy(a) for a in (x, params[:-1], h0,
                                                        c0)),
                        state_size=H, num_layers=L, bidirectional=True)


def _carried_lstm(layout, bidirectional):
    """A JAX ``gluon.rnn.LSTM`` (shapes resolved by one call) and the
    port's layer holding its weights."""
    mx.random.seed(11)
    jnet = mx.gluon.rnn.LSTM(H, num_layers=L, layout=layout,
                             bidirectional=bidirectional)
    jnet.initialize(init=mx.initializer.Xavier())
    shape = (T, N, I) if layout == "TNC" else (N, T, I)
    with jag.predict_mode():
        jnet(mx.nd.zeros(shape))
    pre = jnet.prefix
    params = {k[len(pre):]: p.data().asnumpy()
              for k, p in jnet.collect_params().items()}
    net = rnn.LSTM(H, num_layers=L, layout=layout,
                   bidirectional=bidirectional, input_size=I, device="cpu")
    net.load_gluon_params(params)
    return jnet, net, shape


@pytest.mark.parametrize("layout", ["TNC", "NTC"])
@pytest.mark.parametrize("with_states", [False, True])
def test_gluon_lstm_matches_jax_with_carried_weights(layout, with_states):
    bidirectional = layout == "NTC"
    jnet, net, shape = _carried_lstm(layout, bidirectional)
    rng = np.random.RandomState(6)
    x = rng.randn(*shape).astype(np.float32)
    states = [(rng.randn(L * (1 + bidirectional), N, H) * 0.5)
              .astype(np.float32) for _ in range(2)]
    if with_states:
        jout, jst = jnet(mx.nd.array(x), [mx.nd.array(s) for s in states])
        out, st = net(torch.from_numpy(x),
                      [torch.from_numpy(s) for s in states])
        assert len(st) == 2
        for g, w in zip(st, jst):
            np.testing.assert_allclose(g.numpy(), w.asnumpy(), rtol=1e-5,
                                       atol=1e-5)
    else:
        jout = jnet(mx.nd.array(x))
        out = net(torch.from_numpy(x))
        assert isinstance(out, torch.Tensor)
    assert tuple(out.shape) == tuple(jout.shape)
    np.testing.assert_allclose(out.numpy(), jout.asnumpy(), rtol=1e-5,
                               atol=1e-5)


def test_gluon_lstm_layer_contract():
    # deferred input_size: the first forward gives the input width, as
    # the JAX layer's deferred shape does
    lazy = rnn.LSTM(H, device="cpu")
    assert lazy.collect_params()["l0_i2h_weight"].shape == (4 * H, 0)
    lazy.initialize(init="xavier", seed=1)
    x = np.random.RandomState(3).randn(T, N, I).astype(np.float32)
    assert tuple(lazy(torch.from_numpy(x)).shape) == (T, N, H)
    jlazy = jgluon.rnn.LSTM(H)
    jlazy.initialize(init=mx.initializer.Xavier())
    jlazy(mx.nd.array(x))
    jshapes = {k[len(jlazy.prefix):]: v.shape
               for k, v in jlazy.collect_params().items()}
    assert {k: p.shape for k, p in lazy.collect_params().items()} == jshapes
    with pytest.raises(ValueError, match="layout"):
        rnn.LSTM(H, layout="NCT", input_size=I, device="cpu")
    net = rnn.LSTM(H, num_layers=L, bidirectional=True, input_size=I,
                   device="cpu")
    assert [s.shape for s in net.begin_state(3)] == [(2 * L, 3, H)] * 2
    assert list(net.gluon_params())[:4] == [
        "l0_i2h_weight", "l0_h2h_weight", "l0_i2h_bias", "l0_h2h_bias"]
    assert tuple(net.gluon_params()["r1_i2h_weight"].shape) == (4 * H, 2 * H)
    net.initialize(init="xavier", seed=1)
    for name, p in net.gluon_params().items():
        assert (p.abs().max().item() == 0.0) == name.endswith("bias"), name


def test_dropout_between_layers_keeps_and_scales(monkeypatch):
    """Train mode drops between layers only: about 1 - p of the first
    layer's outputs survive, each scaled by 1 / (1 - p); predict mode
    and the last layer's output are untouched."""
    p, n = 0.3, 512
    seen = []
    run = op_impl_rnn._run_layer

    def spy(x, *args, **kw):
        seen.append(x.detach().clone())
        out = run(x, *args, **kw)
        seen.append(out[0].detach().clone())
        return out
    monkeypatch.setattr(op_impl_rnn, "_run_layer", spy)
    net = rnn.LSTM(H, num_layers=2, dropout=p, input_size=I, device="cpu")
    net.initialize(init="xavier", seed=2)
    x = torch.from_numpy(np.random.RandomState(7).randn(T, n, I)
                         .astype(np.float32))
    with ag.record():
        out = net(x)
    first_out, second_in, second_out = seen[1], seen[2], seen[3]
    torch.testing.assert_close(out, second_out)
    kept = second_in != 0
    frac = kept.float().mean().item()
    assert abs(frac - (1 - p)) < 0.02, frac
    torch.testing.assert_close(second_in[kept], first_out[kept] / (1 - p))
    seen.clear()
    with ag.predict_mode():
        net(x)
    torch.testing.assert_close(seen[2], seen[1])


@pytest.mark.parametrize("max_norm", [0.5, 1e3])
def test_clip_global_norm_matches_jax(max_norm):
    rng = np.random.RandomState(9)
    arrays = [rng.randn(*s).astype(np.float32) for s in ((3, 4), (5,),
                                                         (2, 2, 2))]
    jarr = [mx.nd.array(a) for a in arrays]
    tarr = [torch.from_numpy(a.copy()) for a in arrays]
    jtotal = jax_clip(jarr, max_norm)
    total = clip_global_norm(tarr, max_norm)
    assert isinstance(total, float)
    assert math.isclose(total, float(jtotal), rel_tol=1e-6)
    for t, j in zip(tarr, jarr):
        np.testing.assert_allclose(t.numpy(), j.asnumpy(), rtol=1e-6,
                                   atol=1e-7)
    if max_norm > total:
        for t, a in zip(tarr, arrays):
            assert np.array_equal(t.numpy(), a)


@pytest.mark.parametrize("init", [
    ("xavier", {}), ("xavier", {"factor_type": "in", "magnitude": 2}),
    ("xavier", {"rnd_type": "gaussian", "factor_type": "out"}),
    ("uniform", {"scale": 0.2}), ("normal", {"sigma": 0.05})],
    ids=["xavier", "xavier_in", "xavier_gauss_out", "uniform", "normal"])
def test_initializer_scales_match_the_jax_formulas(init):
    """The port's and the JAX package's draws over one (300, 200)
    weight: uniform draws reach the same bound, Gaussian draws have the
    same deviation (to the sampling error); the port's Xavier formula
    is the JAX one."""
    name, kw = init
    shape = (300, 200)
    t = torch.zeros(shape)
    initializer.create(name, **kw)("dense0_weight", t,
                                   np.random.default_rng(0))
    j = mx.nd.zeros(shape)
    mx.random.seed(0)
    mx.initializer.create(name, **kw)("dense0_weight", j)
    jw = j.asnumpy()
    gauss = name == "normal" or kw.get("rnd_type") == "gaussian"
    stat = (lambda a: a.std()) if gauss else (lambda a: np.abs(a).max())
    assert math.isclose(stat(t.numpy()), stat(jw), rel_tol=0.02)
    if name == "xavier":
        fan_in, fan_out = shape[1], shape[0]
        factor = {"avg": (fan_in + fan_out) / 2, "in": fan_in,
                  "out": fan_out}[kw.get("factor_type", "avg")]
        assert math.isclose(initializer.Xavier(**kw).scale(shape),
                            math.sqrt(kw.get("magnitude", 3) / factor))


def test_initializer_name_dispatch_matches_jax():
    for pname in ("l0_i2h_bias", "ln_gamma", "ln_beta", "bn_running_mean",
                  "bn_running_var", "bn_moving_var", "lstm_bias"):
        t = torch.full((8,), 7.0)
        initializer.Xavier()(pname, t, np.random.default_rng(0))
        j = mx.nd.full((8,), 7.0)
        mx.initializer.Xavier()(pname, j)
        np.testing.assert_array_equal(t.numpy(), j.asnumpy(), err_msg=pname)
    t, j = torch.zeros(16), mx.nd.zeros((16,))
    initializer.LSTMBias(2.0)("l0_h2h_bias", t)
    mx.initializer.LSTMBias(2.0)("l0_h2h_bias", j)
    np.testing.assert_array_equal(t.numpy(), j.asnumpy())
    assert isinstance(initializer.create("zeros"), initializer.Zero)
    with pytest.raises(ValueError, match="unknown initializer"):
        initializer.create("nope")


def test_word_lm_three_steps_match_the_jax_example():
    vocab, emb, hid, layers, bptt, batch = 50, 16, 24, 2, 5, 4
    ex = _jax_example()
    tokens = ex.synthetic_corpus(400, vocab)
    assert np.array_equal(word_lm.synthetic_corpus(400, vocab), tokens)
    data = ex.batchify(tokens, batch)
    assert np.array_equal(word_lm.batchify(tokens, batch), data)

    mx.random.seed(3)
    jnet = ex.WordLM(vocab, emb, hid, layers, dropout=0.0)
    jnet.initialize(init=mx.initializer.Xavier())
    with jag.predict_mode():
        jnet(mx.nd.array(data[:, :bptt]), jnet.begin_state(batch, None))
    pre = jnet.prefix
    net = word_lm.WordLM(vocab, emb, hid, layers, dropout=0.0,
                         device="cpu")
    net.load_gluon_params({k[len(pre):]: p.data().asnumpy()
                           for k, p in jnet.collect_params().items()})

    jparams = [p for p in jnet.collect_params().values()
               if p.grad_req != "null"]
    jtrainer = jgluon.Trainer(jnet.collect_params(), "sgd",
                              {"learning_rate": 1.0})
    loss_fn = jgluon.loss.SoftmaxCrossEntropyLoss()
    jlosses, states = [], jnet.begin_state(batch, None)
    for i in range(0, 3 * bptt, bptt):
        xb = mx.nd.array(data[:, i:i + bptt].astype(np.int32))
        yb = mx.nd.array(data[:, i + 1:i + 1 + bptt].astype(np.float32))
        states = [s.detach() for s in states]
        with jag.record():
            logits, states = jnet(xb, states)
            loss = loss_fn(logits, yb)
        loss.backward()
        jax_clip([p.grad() for p in jparams], 0.25 * bptt * batch)
        jtrainer.step(bptt * batch)
        jlosses.append(float(loss.mean().asscalar()))

    trainer = gluon.Trainer(net.collect_params(), "sgd",
                            {"learning_rate": 1.0})
    losses = [loss.mean().item() for loss in
              word_lm.train_segments(net, trainer, data, bptt, 0.25,
                                     steps=3)]
    assert len(losses) == 3
    np.testing.assert_allclose(losses, jlosses, rtol=1e-5)
    jw = {k[len(pre):]: p.data().asnumpy()
          for k, p in jnet.collect_params().items()}
    for name, p in net.gluon_params().items():
        np.testing.assert_allclose(p.detach().numpy(), jw[name], atol=2e-5,
                                   err_msg=name)
