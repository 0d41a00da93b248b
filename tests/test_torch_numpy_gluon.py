"""np-mode Gluon of the PyTorch port against the JAX package, on the CPU.

Under ``npx.set_np()`` in both packages, on the same numpy-seeded
inputs and carried weights:

- a Dense MLP trains five SGD steps on ``mx.np`` arrays: outputs and
  the loss are ``mx.np.ndarray``s, the losses within 1e-5 relative of
  the JAX package's;
- ``hybridize()`` captures once and its replay equals the eager call
  bit for bit; a recorded replay feeds a Trainer step;
- ``use_np`` turns the mode on inside a call only, in both packages;
- an np-style block (``F.np.dot``, ``F.npx.relu``, ``F.np.mean``) gives
  the JAX block's output within 1e-5, eagerly and hybridized (those two
  bit for bit), and gradients reach its input;
- ``DataLoader`` batches are ``mx.np`` arrays and ``metric`` takes them;
- a 2-layer BERT (32 units, 4 heads, with its pooler) and an MLM head,
  the JAX side on its CPU path: the sequence and pooled outputs within
  1e-5 of scale, the MLM loss within 1e-5 relative, every gradient
  within 2e-5 + 1e-4 of the JAX one; the port's np-mode step equals its
  classic-mode step bit for bit (the model sees plain tensors);
- ``examples/bert_mlm.py --np`` gives the classic run's losses bit for
  bit;
- a tiny LSTM word LM takes three steps on ``mx.np`` token ids under
  ``set_np`` with the port's classic run's losses bit for bit, and the
  fused LSTM layer gives the JAX layer's np-mode output within 1e-5.

``npx.set_np()`` is process-wide in both packages: an autouse fixture
resets it after every test and checks that it is off.
"""
import numpy as onp
import pytest
import torch

import mxnet_tpu as jmx
from mxnet_tpu import util as jutil
from mxnet_tpu.gluon.model_zoo.bert import BERTMLMHead as JaxMLM
from mxnet_tpu.gluon.model_zoo.bert import BERTModel as JaxBERT
import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import graphs, util
from mxnet_tpu_torch.gluon.model_zoo.bert import BERTMLMHead, BERTModel

torch.set_num_threads(1)

tnp, tnpx = tmx.np, tmx.npx
jnp_, jnpx = jmx.np, jmx.npx


@pytest.fixture(autouse=True)
def _np_mode_off_on_the_cpu():
    with tmx.cpu():
        yield
    tnpx.reset_np()
    jnpx.reset_np()
    assert not util.is_np_array() and not util.is_np_shape()
    assert not jutil.is_np_array() and not jutil.is_np_shape()


def _both_np():
    tnpx.set_np()
    jnpx.set_np()


def _carry(jnet, tnet):
    pre = jnet.prefix
    tnet.load_gluon_params({k[len(pre):]: p.data().asnumpy()
                            for k, p in jnet.collect_params().items()})


def _mlp(lib, **kw):
    net = lib.gluon.nn.HybridSequential(**kw)
    with net.name_scope():
        net.add(lib.gluon.nn.Dense(8, activation="relu", in_units=4),
                lib.gluon.nn.Dense(1, in_units=8))
    return net


def test_np_mode_gluon_training_matches_jax():
    _both_np()
    rs = onp.random.RandomState(0)
    x0 = rs.rand(16, 4).astype("f")
    jnet = _mlp(jmx)
    jnet.initialize(init=jmx.initializer.Xavier())
    tnet = _mlp(tmx, prefix=jnet.prefix)
    tnet.initialize()
    _carry(jnet, tnet)
    losses = {}
    for lib, net in ((tmx, tnet), (jmx, jnet)):
        trainer = lib.gluon.Trainer(net.collect_params(), "sgd",
                                    {"learning_rate": 0.05})
        xd = lib.np.array(x0)
        yd = xd.sum(axis=1, keepdims=True) * 0.5
        losses[lib] = []
        for _ in range(5):
            with lib.autograd.record():
                out = net(xd)
                assert type(out).__name__ == "ndarray"
                loss = ((out - yd) ** 2).mean()
            assert type(loss).__name__ == "ndarray"
            loss.backward()
            trainer.step(16)
            losses[lib].append(float(loss))
        grad = next(iter(net.collect_params().values())).grad()
        assert type(grad).__name__ == "ndarray"
    assert losses[tmx][-1] < losses[tmx][0]
    onp.testing.assert_allclose(losses[tmx], losses[jmx], rtol=1e-5)


def test_np_mode_hybridize_replays_eager_and_trains():
    tnpx.set_np()
    net = tmx.gluon.nn.Dense(3, in_units=5)
    net.initialize(seed=2)
    x = tnp.random.uniform(size=(2, 5))
    y0 = net(x)
    net.hybridize()
    before = graphs.captures()
    y1, y2 = net(x), net(x)
    assert graphs.captures() == before + 1
    for y in (y0, y1, y2):
        assert type(y).__name__ == "ndarray"
    assert torch.equal(y1, y0) and torch.equal(y2, y0)
    trainer = tmx.gluon.Trainer(net.collect_params(), "sgd",
                                {"learning_rate": 0.1})
    weight = [p for k, p in net.collect_params().items()
              if k.endswith("weight")][0]
    w0 = weight.data().asnumpy().copy()
    with tmx.autograd.record():
        loss = net(x).sum()
    loss.backward()
    trainer.step(2)
    want = w0 - 0.1 * onp.broadcast_to(x.asnumpy().sum(0), w0.shape) / 2
    onp.testing.assert_allclose(weight.data().asnumpy(), want,
                                rtol=1e-6, atol=1e-6)


def test_use_np_decorator_in_both_packages():
    for lib in (tmx, jmx):
        @lib.util.use_np
        def f():
            assert lib.is_np_array()
            return lib.nd.ones((2,))

        assert not lib.is_np_array()
        assert type(f()).__name__ == "ndarray"
        assert not lib.is_np_array()


def _np_block(lib):
    class NpBlock(lib.gluon.nn.HybridBlock):
        def __init__(self, **kw):
            super().__init__(**kw)
            with self.name_scope():
                self.w = self.params.get("w", shape=(4, 3))

        def hybrid_forward(self, F, x, w):
            h = F.np.dot(x, w.reshape(3, 4))
            return F.npx.relu(h) - F.np.mean(h)

    return NpBlock()


def test_np_style_hybrid_block_matches_jax():
    _both_np()
    x0 = onp.random.RandomState(3).rand(2, 3).astype("f")
    jblk = _np_block(jmx)
    jblk.initialize()
    want = jblk(jnp_.array(x0)).asnumpy()
    tblk = _np_block(tmx)
    tblk.initialize()
    _carry(jblk, tblk)
    x = tnp.array(x0)
    y1 = tblk(x)
    assert type(y1).__name__ == "ndarray" and y1.shape == (2, 4)
    onp.testing.assert_allclose(y1.asnumpy(), want, rtol=1e-5, atol=1e-6)
    tblk.hybridize()
    assert torch.equal(tblk(x), y1)
    x.attach_grad()
    with tmx.autograd.record():
        out = tblk(x).sum()
    out.backward()
    assert type(x.grad).__name__ == "ndarray"
    assert onp.abs(x.grad.asnumpy()).sum() > 0


def test_np_mode_dataloader_and_metric():
    tnpx.set_np()
    xs = onp.random.RandomState(0).rand(10, 3).astype("f")
    ys = onp.arange(10).astype("f") % 2
    loader = tmx.gluon.data.DataLoader(
        tmx.gluon.data.ArrayDataset(xs, ys), batch_size=5)
    n = 0
    for xb, yb in loader:
        assert type(xb).__name__ == "ndarray"
        assert type(yb).__name__ == "ndarray"
        n += 1
    assert n == 2
    for lab, pred in ((tmx.nd.array(ys), tnp.array(onp.eye(2)[ys.astype(int)])
                       .as_nd_ndarray()),
                      (tnp.array(ys), tnp.array(onp.eye(2)[ys.astype(int)]))):
        m = tmx.metric.Accuracy()
        m.update([lab], [pred])
        assert m.get()[1] == 1.0


VOCAB, UNITS, HEADS = 120, 32, 4


def _bert_batch():
    rng = onp.random.RandomState(8)
    lens = onp.array([16, 9, 12], onp.int32)
    ids = rng.randint(0, VOCAB, (3, 16)).astype(onp.int32)
    pos = onp.concatenate([r * 16 + onp.arange(n)
                           for r, n in enumerate(lens)])
    labels = rng.randint(0, VOCAB, len(pos)).astype(onp.int32)
    return ids, lens, pos, labels


def _bert_step(lib, net, head, arrays, mk):
    """Forward, MLM loss and backward; ``mk`` makes the arrays."""
    ids, lens, pos, labels = (mk(a) for a in arrays)
    tt = mk(onp.zeros(arrays[0].shape, onp.int32))
    with lib.autograd.record():
        seq, pooled = net(ids, tt, lens)
        flat = seq.reshape((-1, UNITS))[pos]
        loss = lib.nd.softmax_cross_entropy(head(flat), labels)
    loss.backward()
    return seq, pooled, loss


def _grads(*blocks):
    out = {}
    for b in blocks:
        pre = b.prefix
        out.update({k[len(pre):] if k.startswith(pre) else k:
                    p.grad().asnumpy() for k, p in b.collect_params().items()})
    return out


def test_np_mode_bert_mlm_matches_jax_and_the_classic_step():
    arrays = _bert_batch()
    _both_np()
    jmx.random.seed(5)
    jnet = JaxBERT(vocab_size=VOCAB, units=UNITS, hidden_size=64,
                   num_layers=2, num_heads=HEADS, max_length=40,
                   dropout=0.0, attention_dropout=0.0, use_pooler=True)
    jhead = JaxMLM(VOCAB, UNITS)
    for b in (jnet, jhead):
        b.initialize(init=jmx.initializer.Normal(0.02))
    jseq, jpooled, jloss = _bert_step(jmx, jnet, jhead, arrays,
                                      lambda a: jnp_.array(a))
    assert all(type(v).__name__ == "ndarray" for v in (jseq, jpooled, jloss))
    params = {k: p.data().asnumpy() for k, p in jnet.collect_params().items()}
    hparams = {k: p.data().asnumpy()
               for k, p in jhead.collect_params().items()}
    runs = {}
    for mode in ("np", "classic"):
        if mode == "classic":
            tnpx.reset_np()
        net = BERTModel.from_gluon_params(params, HEADS, device="cpu")
        head = BERTMLMHead.from_gluon_params(hparams, device="cpu")
        mk = tnp.array if mode == "np" else tmx.nd.array
        seq, pooled, loss = _bert_step(tmx, net, head, arrays, mk)
        want = "ndarray" if mode == "np" else "NDArray"
        assert all(type(v).__name__ == want for v in (seq, pooled, loss))
        runs[mode] = (seq, pooled, loss, _grads(net, head))
    seq, pooled, loss, grads = runs["np"]
    for got, w in ((seq, jseq), (pooled, jpooled)):
        w = w.asnumpy()
        assert float(onp.abs(got.asnumpy() - w).max()) <= \
            1e-5 * float(onp.abs(w).max())
    onp.testing.assert_allclose(loss.asnumpy(), jloss.asnumpy(), rtol=1e-5)
    jgrads = _grads(jnet, jhead)
    assert set(grads) == set(jgrads)
    for k, g in grads.items():
        onp.testing.assert_allclose(g, jgrads[k], rtol=1e-4, atol=2e-5,
                                    err_msg=k)
    cseq, cpooled, closs, cgrads = runs["classic"]
    assert torch.equal(seq.as_nd_ndarray(), cseq)
    assert torch.equal(loss.as_nd_ndarray(), closs)
    for k, g in grads.items():
        assert onp.array_equal(g, cgrads[k]), k


def test_bert_mlm_example_np_mode_matches_classic():
    """``examples/bert_mlm.py --np`` (tiny, float32, two steps) gives
    the classic run's losses bit for bit and leaves np-mode off."""
    from mxnet_tpu_torch.examples import bert_mlm

    args = ["--quick", "--device", "cpu", "--amp", "none", "--steps", "2"]
    classic = bert_mlm.main(args)
    assert bert_mlm.main(args + ["--np"]) == classic
    assert not util.is_np_array()


def test_np_mode_lstm_lm_step():
    from mxnet_tpu_torch.examples.word_lm import (WordLM, batchify,
                                                  synthetic_corpus,
                                                  train_segments)
    from mxnet_tpu_torch.initializer import Xavier

    data = batchify(synthetic_corpus(4 * 40, 50), 4)
    losses = {}
    for mode in ("classic", "np"):
        if mode == "np":
            tnpx.set_np()
        net = WordLM(50, 16, 16, 2, dropout=0.0, device="cpu")
        net.initialize(init=Xavier(), seed=4)
        trainer = tmx.gluon.Trainer(net.collect_params(), "sgd",
                                    {"learning_rate": 1.0})
        feed = tnp.array(data) if mode == "np" else data
        out = list(train_segments(net, trainer, feed, 8, 0.25, steps=3))
        want = "ndarray" if mode == "np" else "Tensor"
        assert all(type(o).__name__ == want for o in out)
        losses[mode] = torch.stack([o.as_subclass(torch.Tensor)
                                    for o in out])
    assert torch.equal(losses["np"], losses["classic"])

    # the fused LSTM layer under set_np in both packages
    jnpx.set_np()
    jmx.random.seed(11)
    jl = jmx.gluon.rnn.LSTM(6, num_layers=1, layout="TNC", input_size=5)
    jl.initialize(init=jmx.initializer.Xavier())
    x0 = onp.random.RandomState(6).randn(4, 2, 5).astype("f")
    want = jl(jnp_.array(x0))
    tl = tmx.gluon.rnn.LSTM(6, num_layers=1, layout="TNC", input_size=5,
                            device="cpu")
    _carry(jl, tl)
    got = tl(tnp.array(x0))
    assert type(got).__name__ == "ndarray" == type(want).__name__
    onp.testing.assert_allclose(got.asnumpy(), want.asnumpy(), rtol=1e-5,
                                atol=1e-5)
