"""The PyTorch port's training path against the JAX package's, on the
CPU: ``autograd.record()`` -> BERT + head -> loss -> ``backward()`` ->
``gluon.Trainer.step()``.

- The JAX package's own training golden
  (``tests/test_transformer.py::test_bert_mlm_nsp_training_step``: a
  1-layer BERT with MLM and NSP heads, ``SoftmaxCrossEntropyLoss``,
  Adam) replayed in the port with the JAX weights: the losses of all
  five steps agree within 1e-5 relative.
- A tiny BERT + MLM head trained through ``nd.softmax_cross_entropy``
  (the fused K4 path) on a padded batch (``valid_length`` on the flash
  path, the valid positions gathered), with the JAX side's kernels in
  interpret mode: every parameter gradient of the first step agrees
  within 2e-5 absolute + 1e-4 relative, and every weight after two
  Trainer steps within 2e-5 (the same float32 math summed in another
  order; Adam divides by the square root of small second moments, so
  the weights carry the gradients' rounding a little amplified). One
  encoder layer and two steps cover every kernel, parameter kind and
  Adam's carried moments; a second layer or step would repeat them
  at the cost of the JAX side's interpret-mode kernels.

The port's kernels take their plain versions on CPU tensors, through
the same autograd Functions the card uses.
"""
import numpy as np
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu import autograd as jag
from mxnet_tpu import gluon as jgluon
from mxnet_tpu.gluon.model_zoo import bert_base
from mxnet_tpu.gluon.model_zoo.bert import BERTMLMHead as JaxMLM
from mxnet_tpu.gluon.model_zoo.bert import BERTModel as JaxBERT
from mxnet_tpu.gluon.model_zoo.bert import BERTNSPHead as JaxNSP
from mxnet_tpu_torch import autograd as ag
from mxnet_tpu_torch import gluon, kvstore, nd
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.gluon.model_zoo.bert import (BERTMLMHead, BERTModel,
                                                  BERTNSPHead)

torch.set_num_threads(1)


def _numpy_params(block):
    return {k: p.data().asnumpy() for k, p in block.collect_params().items()}


def _merged(*blocks):
    out = {}
    for b in blocks:
        out.update(b.collect_params().items())
    return out


def test_jax_bert_mlm_nsp_training_golden_replays():
    """tests/test_transformer.py:97-127, step for step."""
    rng = np.random.RandomState(3)
    V = 100
    net = bert_base(vocab_size=V, max_length=32, num_layers=1, units=32,
                    hidden_size=64, num_heads=4, dropout=0.0)
    mlm = JaxMLM(V, 32)
    nsp = JaxNSP()
    for b in (net, mlm, nsp):
        b.initialize(init=mx.initializer.Normal(0.02))
    ids = mx.nd.array(rng.randint(0, V, (4, 16)), dtype="int32")
    tt = mx.nd.zeros((4, 16), dtype="int32")
    mlm_lab = mx.nd.array(rng.randint(0, V, (4, 16)), dtype="int32")
    nsp_lab = mx.nd.array(rng.randint(0, 2, (4,)), dtype="int32")
    with jag.predict_mode():                  # resolve deferred shapes
        seq, pooled = net(ids, tt)
        mlm(seq)
        nsp(pooled)
    tnet = BERTModel.from_gluon_params(_numpy_params(net), 4, device="cpu")
    tmlm = BERTMLMHead.from_gluon_params(_numpy_params(mlm), device="cpu")
    tnsp = BERTNSPHead.from_gluon_params(_numpy_params(nsp), device="cpu")

    params = {}
    for b in (net, mlm, nsp):
        params.update(b.collect_params())
    trainer = jgluon.Trainer(params, "adam", {"learning_rate": 1e-3})
    loss_fn = jgluon.loss.SoftmaxCrossEntropyLoss()
    ttrainer = gluon.Trainer(_merged(tnet, tmlm, tnsp), "adam",
                             {"learning_rate": 1e-3})
    tloss_fn = gluon.loss.SoftmaxCrossEntropyLoss()
    t_ids, t_tt, t_mlm, t_nsp = (torch.from_numpy(np.array(a.asnumpy()))
                                 for a in (ids, tt, mlm_lab, nsp_lab))

    losses, tlosses = [], []
    for _ in range(5):
        with jag.record():
            seq, pooled = net(ids, tt)
            l_mlm = loss_fn(mlm(seq).reshape((-1, V)), mlm_lab.reshape((-1,)))
            l_nsp = loss_fn(nsp(pooled), nsp_lab)
            loss = l_mlm.mean() + l_nsp.mean()
        loss.backward()
        trainer.step(4)
        losses.append(float(loss.asnumpy()))
        with ag.record():
            seq, pooled = tnet(t_ids, t_tt)
            l_mlm = tloss_fn(tmlm(seq).reshape(-1, V), t_mlm.reshape(-1))
            l_nsp = tloss_fn(tnsp(pooled), t_nsp)
            tloss = l_mlm.mean() + l_nsp.mean()
        tloss.backward()
        ttrainer.step(4)
        tlosses.append(tloss.item())
    assert losses[-1] < losses[0]
    np.testing.assert_allclose(tlosses, losses, rtol=1e-5)


VOCAB, UNITS, HEADS = 120, 32, 4


def _batch():
    rng = np.random.RandomState(8)
    lens = np.array([16, 9, 12], np.int32)
    ids = rng.randint(0, VOCAB, (3, 16)).astype(np.int32)
    pos = np.concatenate([r * 16 + np.arange(n)
                          for r, n in enumerate(lens)]).astype(np.int32)
    labels = rng.randint(0, VOCAB, len(pos)).astype(np.int32)
    return ids, lens, pos, labels


def test_tiny_bert_mlm_trainer_matches_jax_on_its_kernels(monkeypatch):
    monkeypatch.setenv("MXNET_TPU_PALLAS_INTERPRET", "1")
    mx.random.seed(5)
    net = JaxBERT(vocab_size=VOCAB, units=UNITS, hidden_size=64,
                  num_layers=1, num_heads=HEADS, max_length=40,
                  dropout=0.0, attention_dropout=0.0, use_pooler=False)
    head = JaxMLM(VOCAB, UNITS)
    for b in (net, head):
        b.initialize(init=mx.initializer.Normal(0.02))
    ids, lens, pos, labels = _batch()
    j_ids, j_lens, j_pos, j_lab = (mx.nd.array(a, dtype="int32")
                                   for a in (ids, lens, pos, labels))
    j_tt = mx.nd.zeros(ids.shape, dtype="int32")
    with jag.predict_mode():
        head(net(j_ids, j_tt, j_lens))
    tnet = BERTModel.from_gluon_params(_numpy_params(net), HEADS,
                                       device="cpu")
    thead = BERTMLMHead.from_gluon_params(_numpy_params(head), device="cpu")

    jparams = {}
    for b in (net, head):
        jparams.update(b.collect_params())
    trainer = jgluon.Trainer(jparams, "adam", {"learning_rate": 1e-3,
                                               "wd": 0.01})
    tparams = _merged(tnet, thead)
    ttrainer = gluon.Trainer(tparams, "adam", {"learning_rate": 1e-3,
                                               "wd": 0.01})
    t_ids, t_lens, t_pos, t_lab = (torch.from_numpy(a) for a in
                                   (ids, lens, pos, labels))
    t_tt = torch.zeros_like(t_ids)
    n_valid = int(lens.sum())
    jnames = {name: jname for name in tparams for jname in jparams
              if jname.endswith(name)
              and jname[:-len(name)] in (net.prefix, head.prefix)}
    assert len(jnames) == len(tparams) == len(jparams)

    for step in range(2):
        with jag.record():
            seq = net(j_ids, j_tt, j_lens)
            flat = mx.nd.take(seq.reshape((-1, UNITS)), j_pos)
            loss = mx.nd.softmax_cross_entropy(head(flat), j_lab)
        loss.backward()
        with ag.record():
            seq = tnet(t_ids, t_tt, t_lens)
            flat = seq.reshape(-1, UNITS)[t_pos.long()]
            tloss = nd.softmax_cross_entropy(thead(flat), t_lab)
        tloss.backward()
        np.testing.assert_allclose(tloss.item(), float(loss.asnumpy()[0]),
                                   rtol=1e-5)
        if step == 0:
            for name, p in tparams.items():
                np.testing.assert_allclose(
                    p.grad().numpy(), jparams[jnames[name]].grad().asnumpy(),
                    atol=2e-5, rtol=1e-4, err_msg=name)
        trainer.step(n_valid)
        ttrainer.step(n_valid)
    for name, p in tparams.items():
        np.testing.assert_allclose(p.data().detach().numpy(),
                                   jparams[jnames[name]].data().asnumpy(),
                                   atol=2e-5, err_msg=name)


def _tiny_dense():
    from mxnet_tpu_torch.gluon import nn

    layer = nn.Dense(2, in_units=3, device="cpu").initialize(seed=3)
    return layer, layer.collect_params()


def test_step_rescales_by_batch_size_on_top_of_the_loss():
    layer, params = _tiny_dense()
    trainer = gluon.Trainer(params, "sgd", {"learning_rate": 1.0,
                                            "rescale_grad": 3.0})
    w0 = params["weight"].data().detach().clone()
    x = torch.randn(4, 3)
    with ag.record():
        layer(x).sum().backward()
    g = params["weight"].grad().clone()
    trainer.step(6)
    assert trainer.optimizer.rescale_grad == 0.5
    assert torch.allclose(params["weight"].data(), w0 - 0.5 * g)
    trainer.set_learning_rate(0.25)
    assert trainer.learning_rate == 0.25


def test_null_grad_req_parameters_are_not_updated():
    layer, params = _tiny_dense()
    params["bias"].grad_req = "null"
    b0 = params["bias"].data().detach().clone()
    trainer = gluon.Trainer(params, "adam", {"learning_rate": 0.1})
    with ag.record():
        layer(torch.randn(4, 3)).sum().backward()
    trainer.step(1)
    assert torch.equal(params["bias"].data(), b0)
    assert params["bias"].data().grad is None


def test_kvstore_rules():
    _, params = _tiny_dense()
    for kv in (None, "device", "local", "nccl", kvstore.create("local")):
        gluon.Trainer(params, "sgd", kvstore=kv)
    with pytest.raises(NotImplementedError, match="Multi-GPU"):
        gluon.Trainer(params, "sgd", kvstore="dist_sync")
    with pytest.raises(MXNetError, match="kvstore"):
        gluon.Trainer(params, "sgd", kvstore="nccl2")
    with pytest.raises(ValueError, match="Parameters"):
        gluon.Trainer([torch.zeros(2)], "sgd")


def test_save_and_load_states_continue_the_run(tmp_path):
    """Adam's per-index counts (its bias correction) and moments ride
    in the saved states: a trainer that loads them continues exactly
    as the one that saved them."""
    runs = []
    for reload in (False, True):
        layer, params = _tiny_dense()
        trainer = gluon.Trainer(params, "adam", {"learning_rate": 0.1})
        gen = torch.Generator().manual_seed(0)
        for step in range(4):
            if reload and step == 2:
                trainer.save_states(str(tmp_path / "t.states"))
                trainer = gluon.Trainer(params, "adam",
                                        {"learning_rate": 0.1})
                trainer.load_states(str(tmp_path / "t.states"))
            with ag.record():
                layer(torch.randn(4, 3, generator=gen)).sum().backward()
            trainer.step(4)
        runs.append(params["weight"].data().detach().clone())
    assert torch.equal(runs[0], runs[1])
    assert trainer.optimizer.num_update == 4


@pytest.mark.parametrize("case", ["l2", "sparse", "dense", "weighted"])
def test_losses_match_the_jax_package(case):
    """Per-sample losses and their input gradients against the JAX
    layers (float32, 1e-6: a few terms per sample)."""
    rng = np.random.RandomState(12)
    pred = rng.randn(6, 5).astype(np.float32)
    label = rng.randint(0, 5, 6).astype(np.float32)
    sample_w = rng.rand(6, 1).astype(np.float32)
    kw, args = {}, (label,)
    if case == "l2":
        label = rng.randn(6, 5).astype(np.float32)
        jfn, tfn = jgluon.loss.L2Loss(), gluon.loss.L2Loss()
        args = (label,)
    else:
        if case == "dense":
            kw = dict(sparse_label=False)
            label = np.eye(5, dtype=np.float32)[label.astype(int)]
            args = (label,)
        elif case == "weighted":
            kw = dict(weight=0.5)
            args = (label, sample_w)
        jfn = jgluon.loss.SoftmaxCrossEntropyLoss(**kw)
        tfn = gluon.loss.SoftmaxCrossEntropyLoss(**kw)
    jx = mx.nd.array(pred)
    jx.attach_grad()
    with jag.record():
        jl = jfn(jx, *(mx.nd.array(a) for a in args))
    jl.backward()
    tx = torch.from_numpy(pred).requires_grad_()
    with ag.record():
        tl = tfn(tx, *(torch.from_numpy(a) for a in args))
    ag.backward(tl)
    assert tl.shape == (6,)
    np.testing.assert_allclose(tl.detach().numpy(), jl.asnumpy(), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(tx.grad.numpy(), jx.grad.asnumpy(),
                               rtol=1e-6, atol=1e-6)
