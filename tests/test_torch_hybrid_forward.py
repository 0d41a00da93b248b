"""User ``HybridBlock``s on the port: ``hybrid_forward(F, x, ...)`` with
``F`` the op registry, parameters from ``self.params.get(...)`` and
``get_constant(...)``, nested children, deferred shapes, and
``examples/hybrid_bert.py`` (a BERT trunk and MLM head written in
F-ops), held against the JAX package on the CPU.

The BERT case: 2 layers, 64 units, 4 heads, vocabulary 100, the port's
F-op model with the weights of the JAX package's model-zoo BERT and
``BERTMLMHead`` against that JAX model on a padded batch (valid lengths
on the flash path, the valid positions predicted), the JAX side's flash
kernel on its plain path: the losses of three Adam steps within 1e-5
relative, every step-1 gradient within 2e-5 absolute + 1e-4 relative,
the weights after the steps within 2e-5 (the tolerances of
``test_torch_trainer.py``'s model-zoo case); with the JAX side's
kernels in interpret mode, the forward and its loss (their interpreted
backward kernels would cost ~20 s more on the CPU). The same
``build`` also runs on the JAX package's ``gluon``: its loss equals the
model zoo's there.
"""
import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx
from mxnet_tpu import autograd as jag
from mxnet_tpu import gluon as jgluon
from mxnet_tpu.gluon.model_zoo.bert import BERTMLMHead as JaxMLM
from mxnet_tpu.gluon.model_zoo.bert import BERTModel as JaxBERT
from mxnet_tpu_torch import autograd as ag
from mxnet_tpu_torch import gluon, nd
from mxnet_tpu_torch.examples import hybrid_bert
from mxnet_tpu_torch.gluon import nn

torch.set_num_threads(1)

X = np.random.RandomState(4).uniform(-1, 1, (4, 3)).astype(np.float32)


def test_user_hybrid_forward_block_runs():
    """The reference's pattern: ``hybrid_forward(self, F, x)`` calling a
    child and an F-op; NDArray in, NDArray out."""
    class Net(gluon.HybridBlock):
        def __init__(self, **kwargs):
            super().__init__(**kwargs)
            with self.name_scope():
                self.dense = nn.Dense(5, in_units=3)

        def hybrid_forward(self, F, x):
            return F.Activation(self.dense(x), act_type="relu")

    with tmx.cpu():
        net = Net()
        net.initialize()
        out = net(nd.array(X))
        w, b = net.dense.weight.detach(), net.dense.bias.detach()
    assert isinstance(out, nd.NDArray)
    want = np.maximum(X @ w.numpy().T + b.numpy(), 0)
    np.testing.assert_allclose(out.asnumpy(), want, rtol=1e-6, atol=1e-6)


class _Scaled:
    """A block with ``params.get`` weights (one deferred), a constant
    and a nested child, built on either package's ``gluon``."""

    @staticmethod
    def build(g, units=2):
        class Inner(g.HybridBlock):
            def __init__(self, **kwargs):
                super().__init__(**kwargs)
                with self.name_scope():
                    self.weight = self.params.get(
                        "weight", shape=(units, 0), allow_deferred_init=True)
                    self.bias = self.params.get("bias", shape=(units,),
                                                init="zeros")

            def infer_shape(self, x):
                self.weight.shape = (units, x.shape[-1])

            def hybrid_forward(self, F, x, weight, bias):
                return F.FullyConnected(x, weight, bias, num_hidden=units)

        class Outer(g.HybridBlock):
            def __init__(self, **kwargs):
                super().__init__(**kwargs)
                with self.name_scope():
                    self.inner = Inner(prefix="inner_")
                    self.scale = self.params.get("scale", shape=(1, units))
                    self.const = self.params.get_constant(
                        "const", [[1.0, 2.0]])

            def hybrid_forward(self, F, x, scale, const):
                return F.broadcast_add(F.broadcast_mul(self.inner(x), scale),
                                       const)

        return Outer(prefix="outer_")


def test_params_get_constant_nested_and_deferred_match_jax():
    jnet = _Scaled.build(jgluon)
    jnet.initialize()
    jx = jmx.nd.array(X)
    jnet(jx)                          # finishes the deferred weight
    jparams = {k[len(jnet.prefix):]: v.data().asnumpy()
               for k, v in jnet.collect_params().items()}
    with tmx.cpu():
        net = _Scaled.build(gluon)
        net.initialize()
        assert net.inner.weight.shape == (2, 0)       # deferred
        params = net.collect_params()
        assert set(params.keys()) == set(jparams) == {
            "inner_weight", "inner_bias", "scale", "const"}
        assert params["const"].grad_req == "null"
        x = nd.array(X)
        x.attach_grad()
        with ag.record():
            out = net(x)
        assert net.inner.weight.shape == (2, 3)
        for k, v in params.items():
            v.set_data(jparams[k])
        with ag.record():
            out = net(x)
        out.backward()
    jx.attach_grad()
    with jag.record():
        jout = jnet(jx)
    jout.backward()
    np.testing.assert_allclose(out.asnumpy(), jout.asnumpy(), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(x.grad.asnumpy(), jx.grad.asnumpy(),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(
        net.scale.grad().asnumpy(),
        jnet.collect_params()[jnet.prefix + "scale"].grad().asnumpy(),
        rtol=1e-6, atol=1e-6)
    # the constant: the value it was given, no gradient, kept by
    # initialize(force_reinit=True)
    with tmx.cpu():
        net.initialize(force_reinit=True)
    np.testing.assert_array_equal(net.const.data().asnumpy(), [[1.0, 2.0]])


def test_get_constant_pattern_of_the_reference_tests():
    """tests/test_gluon.py:162 on the port."""
    class Net(gluon.HybridBlock):
        def __init__(self, **kw):
            super().__init__(**kw)
            self.const = self.params.get_constant("const", [[1.0, 2.0]])

        def hybrid_forward(self, F, x, const):
            return x + const

    with tmx.cpu():
        net = Net()
        net.initialize()
        out = net(nd.zeros((1, 2)))
    assert (out.asnumpy() == [[1, 2]]).all()


def test_block_params_is_its_parameter_dict():
    with tmx.cpu():
        d = nn.Dense(4, in_units=3, prefix="d_")
        assert d.params.prefix == "d_"
        assert set(d.params.keys()) == {"weight", "bias"}
        assert d.params.get("weight").shape == (4, 3)
        shared = nn.Dense(4, in_units=3, params=d.collect_params())
        assert shared.weight is d.weight


CFG = dict(vocab_size=100, units=64, num_layers=2, num_heads=4,
           hidden_size=128, max_length=32)


def _batch():
    rs = np.random.RandomState(9)
    b, s = 3, 12
    ids = rs.randint(1, CFG["vocab_size"], (b, s)).astype(np.int32)
    lens = np.array([12, 7, 9], np.int32)
    pos = np.concatenate([np.arange(n) + i * s
                          for i, n in enumerate(lens)]).astype(np.int32)
    labels = rs.randint(0, CFG["vocab_size"], pos.shape).astype(np.int32)
    return ids, np.zeros_like(ids), lens, pos, labels


@pytest.mark.parametrize("jax_path,steps", [("interpret", 0),
                                            ("plain", 3)])
def test_hybrid_bert_matches_the_jax_model_zoo(monkeypatch, jax_path, steps):
    if jax_path == "interpret":
        monkeypatch.setenv("MXNET_TPU_PALLAS_INTERPRET", "1")
    jmx.random.seed(5)
    U = CFG["units"]
    jnet = JaxBERT(vocab_size=CFG["vocab_size"], units=U,
                   hidden_size=CFG["hidden_size"],
                   num_layers=CFG["num_layers"], num_heads=CFG["num_heads"],
                   max_length=CFG["max_length"], dropout=0.0,
                   attention_dropout=0.0, use_pooler=False)
    jhead = JaxMLM(CFG["vocab_size"], U)
    for b in (jnet, jhead):
        b.initialize(init=jmx.initializer.Normal(0.05))
    batch = _batch()
    j_ids, j_tt, j_lens, j_pos, j_lab = (jmx.nd.array(a, dtype="int32")
                                         for a in batch)
    with jag.predict_mode():
        jhead(jnet(j_ids, j_tt, j_lens))          # finish deferred shapes
    trunk = {k[len(jnet.prefix):]: v.data().asnumpy()
             for k, v in jnet.collect_params().items()}
    head = {k[len(jhead.prefix):]: v.data().asnumpy()
            for k, v in jhead.collect_params().items()}
    jparams = dict(jnet.collect_params().items())
    jparams.update(jhead.collect_params().items())
    jtrainer = jgluon.Trainer(jparams, "adam", {"learning_rate": 1e-3})
    with tmx.cpu():
        net = hybrid_bert.build(gluon, **CFG)
        net.initialize()
        hybrid_bert.load_weights(net, trunk, head)
        tparams = net.collect_params()
        trainer = gluon.Trainer(tparams, "adam", {"learning_rate": 1e-3})
    t_batch = [torch.from_numpy(a) for a in batch]
    n_valid = int(batch[2].sum())

    def jname(name):
        part, z = hybrid_bert.zoo_name(name)
        return (jnet.prefix if part == "trunk" else jhead.prefix) + z

    assert {jname(n) for n in tparams.keys()} == set(jparams)
    with jag.predict_mode():
        jloss = jmx.nd.softmax_cross_entropy(
            jhead(jmx.nd.take(jnet(j_ids, j_tt, j_lens).reshape((-1, U)),
                              j_pos)), j_lab)
    np.testing.assert_allclose(net(*t_batch).item(),
                               float(jloss.asnumpy()[0]), rtol=1e-5)
    for step in range(steps):
        with jag.record():
            seq = jnet(j_ids, j_tt, j_lens)
            flat = jmx.nd.take(seq.reshape((-1, U)), j_pos)
            jloss = jmx.nd.softmax_cross_entropy(jhead(flat), j_lab)
        jloss.backward()
        with ag.record():
            loss = net(*t_batch)
        loss.backward()
        np.testing.assert_allclose(loss.item(), float(jloss.asnumpy()[0]),
                                   rtol=1e-5)
        if step == 0:
            for name, p in tparams.items():
                np.testing.assert_allclose(
                    p.grad().numpy(), jparams[jname(name)].grad().asnumpy(),
                    atol=2e-5, rtol=1e-4, err_msg=name)
        jtrainer.step(n_valid)
        trainer.step(n_valid)
    for name, p in tparams.items():
        np.testing.assert_allclose(p.data().detach().numpy(),
                                   jparams[jname(name)].data().asnumpy(),
                                   atol=2e-5, err_msg=name)
    if jax_path == "plain":
        # the same definition on the JAX package's gluon: the model
        # zoo's loss, with the model zoo's weights as they are now
        jh = hybrid_bert.build(jgluon, **CFG)
        jh.initialize()
        hybrid_bert.load_weights(jh, jnet, jhead)
        with jag.predict_mode():
            l_zoo = jmx.nd.softmax_cross_entropy(
                jhead(jmx.nd.take(jnet(j_ids, j_tt, j_lens)
                                  .reshape((-1, U)), j_pos)), j_lab)
            l_hyb = jh(j_ids, j_tt, j_lens, j_pos, j_lab)
        np.testing.assert_allclose(l_hyb.asnumpy(), l_zoo.asnumpy(),
                                   rtol=1e-5)
