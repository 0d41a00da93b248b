"""Gluon's ``Estimator``, ``gluon.contrib.nn`` and ``contrib.tensorboard``
of the PyTorch port against the JAX package's, on the CPU.

- ``tests/test_profiler.py::test_estimator_fit`` in both packages, from
  the same weights over the same batches: each epoch's accuracy and the
  final weights within 1e-5 (the same float32 math summed in another
  order, through three epochs of Adam).
- The event handlers as MXNet 1.6 runs them (the port calls every
  handler at its events; the JAX ``fit`` calls only ``LoggingHandler``):
  ``StoppingHandler`` by batches and by epochs, ``ValidationHandler``
  by epochs and by batches and as ``fit(val_data=...)``'s default,
  ``MetricHandler``'s reset each epoch, ``EarlyStoppingHandler``,
  ``CheckpointHandler``; ``evaluate`` against the JAX one.
- Each contrib layer on the same inputs and weights as the JAX layer's,
  within 1e-5 of scale (``Identity`` exactly); ``PixelShuffle2D``
  exactly against MXNet's definition in numpy (the JAX layer cannot
  run: see its test).
- A TensorBoard event file written by both packages at a fixed clock
  holds the same bytes, record for record; ``LogMetricsCallback``
  writes the metric's scalars.
"""
import logging
import os
import struct
import time

import numpy as np
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu import autograd as jag
from mxnet_tpu import gluon as jgluon
from mxnet_tpu.contrib import tensorboard as jtb
from mxnet_tpu.gluon.contrib import estimator as jest
from mxnet_tpu.gluon.contrib import nn as jcnn
import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import autograd as ag
from mxnet_tpu_torch import gluon
from mxnet_tpu_torch.contrib import tensorboard as ttb
from mxnet_tpu_torch.gluon.contrib import estimator as test_
from mxnet_tpu_torch.gluon.contrib import nn as tcnn
from mxnet_tpu_torch.gluon import nn

torch.set_num_threads(1)


def _data(n=64, seed=0):
    rs = np.random.RandomState(seed)
    x = rs.randn(n, 6).astype(np.float32)
    w = rs.randn(6, 3).astype(np.float32)
    return x, (x @ w).argmax(1).astype(np.float32)


def _nets(seed=0):
    """The JAX MLP (Xavier from ``seed``) and the port's with its
    weights."""
    mx.random.seed(seed)
    jnet = jgluon.nn.HybridSequential()
    jnet.add(jgluon.nn.Dense(16, activation="relu", in_units=6),
             jgluon.nn.Dense(3, in_units=16))
    jnet.initialize(init=mx.initializer.Xavier())
    net = nn.HybridSequential()
    net.add(nn.Dense(16, activation="relu", in_units=6, device="cpu"),
            nn.Dense(3, in_units=16, device="cpu"))
    for tp, jp in zip(net.collect_params().values(),
                      jnet.collect_params().values()):
        tp.set_data(jp.data().asnumpy())
    return jnet, net


def _loader(x, y, batch_size=16):
    return gluon.data.DataLoader(gluon.data.ArrayDataset(x, y),
                                 batch_size=batch_size, device="cpu")


def _estimator(net, lr=5e-3):
    return test_.Estimator(
        net=net, loss=gluon.loss.SoftmaxCrossEntropyLoss(),
        trainer=gluon.Trainer(net.collect_params(), "adam",
                              {"learning_rate": lr}),
        metrics=tmx.metric.Accuracy())


class _Epochs:
    """A LoggingHandler that keeps each epoch's training metrics (the
    JAX ``fit`` calls a LoggingHandler's ``epoch_end`` only)."""

    def make(self, base):
        seen = self.seen = []

        class Keep(base):
            def epoch_end(self, estimator, epoch=0, *args, **kwargs):
                seen.append([m.get()[1] for m in estimator.train_metrics])
                return False

        return Keep()


def test_estimator_fit_matches_jax():
    """tests/test_profiler.py::test_estimator_fit, in both packages."""
    x, y = _data()
    jnet, net = _nets()
    jtrainer = jgluon.Trainer(jnet.collect_params(), "adam",
                              {"learning_rate": 5e-3})
    jkeep, tkeep = _Epochs(), _Epochs()
    jest.Estimator(net=jnet, loss=jgluon.loss.SoftmaxCrossEntropyLoss(),
                   trainer=jtrainer, metrics=mx.metric.Accuracy()).fit(
        train_data=jgluon.data.DataLoader(jgluon.data.ArrayDataset(x, y),
                                          batch_size=16),
        epochs=3, event_handlers=[jkeep.make(jest.LoggingHandler)])
    _estimator(net).fit(train_data=_loader(x, y), epochs=3,
                        event_handlers=[tkeep.make(test_.LoggingHandler)])
    assert len(tkeep.seen) == len(jkeep.seen) == 3
    np.testing.assert_allclose(tkeep.seen, jkeep.seen, atol=1e-5)
    for tp, jp in zip(net.collect_params().values(),
                      jnet.collect_params().values()):
        np.testing.assert_allclose(tp.data().numpy(), jp.data().asnumpy(),
                                   atol=1e-5, err_msg=tp.name)


class _Count(test_.BatchEnd, test_.EpochEnd):
    def __init__(self):
        self.batches = self.epochs = 0

    def batch_end(self, estimator, *args, **kwargs):
        self.batches += 1
        return False

    def epoch_end(self, estimator, *args, **kwargs):
        self.epochs += 1
        return False


@pytest.mark.parametrize("limit,want", [
    ({"max_batch": 5}, (5, 2)), ({"max_epoch": 2}, (8, 2)),
    ({"max_epoch": 3, "max_batch": 100}, (12, 3))])
def test_stopping_handler(limit, want):
    x, y = _data()
    _, net = _nets()
    count = _Count()
    stop = test_.StoppingHandler(**limit)
    _estimator(net).fit(_loader(x, y), epochs=10,
                        event_handlers=[count, stop])
    assert (count.batches, count.epochs) == want
    assert stop.stop_training


def test_fit_batches_caps_each_epoch_as_the_jax_fit():
    x, y = _data()
    _, net = _nets()
    count = _Count()
    _estimator(net).fit(_loader(x, y), epochs=3, batches=2,
                        event_handlers=[count])
    assert (count.batches, count.epochs) == (6, 3)


def test_validation_handler_periods_and_default():
    x, y = _data()
    vx, vy = _data(32, seed=1)
    _, net = _nets()
    est = _estimator(net)
    val = test_.ValidationHandler(_loader(vx, vy), est.evaluate,
                                  epoch_period=1, batch_period=3)
    est.fit(_loader(x, y), epochs=2, event_handlers=[val])
    # 8 batches: after batches 3 and 6, and after each of 2 epochs
    assert len(val.results) == 4
    assert val.results[-1] == est.evaluate(_loader(vx, vy))
    # fit(val_data=...) adds one, over copies of the training metrics
    est.fit(_loader(x, y), val_data=_loader(vx, vy), epochs=1)
    assert est.val_metrics[0].num_inst == len(vx)
    assert est.train_metrics[0].num_inst == len(x)
    assert est.val_metrics[0] is not est.train_metrics[0]


def test_evaluate_matches_jax():
    vx, vy = _data(32, seed=1)
    jnet, net = _nets()
    jval = jest.Estimator(net=jnet, loss=jgluon.loss.SoftmaxCrossEntropyLoss(),
                          metrics=mx.metric.Accuracy()).evaluate(
        jgluon.data.DataLoader(jgluon.data.ArrayDataset(vx, vy),
                               batch_size=8))
    tval = _estimator(net).evaluate(_loader(vx, vy, 8))
    assert [n for n, _ in tval] == [n for n, _ in jval]
    np.testing.assert_allclose([v for _, v in tval], [v for _, v in jval],
                               atol=1e-6)


def test_metric_handler_resets_each_epoch():
    x, y = _data()
    _, net = _nets()
    est = _estimator(net)
    est.fit(_loader(x, y), epochs=3)
    assert est.train_metrics[0].num_inst == len(x)


def test_early_stopping_and_checkpoints(tmp_path, caplog):
    x, y = _data()
    _, net = _nets()
    est = _estimator(net, lr=0.0)           # nothing moves: no progress
    count = _Count()
    early = test_.EarlyStoppingHandler(est.train_metrics[0], patience=2)
    ckpt = test_.CheckpointHandler(str(tmp_path), model_prefix="mlp")
    with caplog.at_level(logging.INFO):
        est.fit(_loader(x, y), epochs=10,
                event_handlers=[count, early, ckpt])
    # epoch 0 sets the best; epochs 1 and 2 do not beat it
    assert count.epochs == 3 and early.stopped_epoch == 2
    assert sorted(os.listdir(tmp_path)) == [
        f"mlp-epoch{i}.params" for i in range(3)]
    assert "Epoch[2] accuracy=" in caplog.text
    loaded = nn.HybridSequential()
    loaded.add(nn.Dense(16, activation="relu", in_units=6, device="cpu"),
               nn.Dense(3, in_units=16, device="cpu"))
    loaded.load_parameters(str(tmp_path / "mlp-epoch2.params"))
    for a, b in zip(loaded.collect_params().values(),
                    net.collect_params().values()):
        assert torch.equal(a.data(), b.data())


# -- gluon.contrib.nn ---------------------------------------------------------
def _carry(jblock, tblock):
    for tp, jp in zip(tblock.collect_params().values(),
                      jblock.collect_params().values()):
        tp.set_data(np.asarray(jp.data().asnumpy(), np.float32))


def _concurrent(lib, kind):
    cnn_, nn_ = (jcnn, jgluon.nn) if lib == "jax" else (tcnn, nn)
    dev = {} if lib == "jax" else {"device": "cpu"}
    block = getattr(cnn_, kind)(axis=1)
    block.add(nn_.Dense(4, in_units=5, **dev),
              nn_.Dense(3, activation="tanh", in_units=5, **dev),
              (cnn_.Identity()))
    return block


def _contrib_cases():
    rs = np.random.RandomState(3)
    vec = rs.randn(2, 5).astype(np.float32)
    img = rs.randn(2, 8, 3, 3).astype(np.float32)
    ids = rs.randint(0, 9, (2, 4)).astype(np.float32)
    return {
        "Concurrent": (lambda lib: _concurrent(lib, "Concurrent"), vec),
        "HybridConcurrent": (lambda lib: _concurrent(lib, "HybridConcurrent"),
                             vec),
        "Identity": (lambda lib: (jcnn if lib == "jax" else tcnn).Identity(),
                     vec),
        "SparseEmbedding": (lambda lib: jcnn.SparseEmbedding(9, 4)
                            if lib == "jax" else
                            tcnn.SparseEmbedding(9, 4, device="cpu"), ids),
        "SyncBatchNorm": (lambda lib: jcnn.SyncBatchNorm(in_channels=8)
                          if lib == "jax" else
                          tcnn.SyncBatchNorm(in_channels=8, device="cpu"),
                          img),
    }


@pytest.mark.parametrize("case", sorted(_contrib_cases()))
@pytest.mark.parametrize("train", [False, True])
def test_contrib_nn_matches_jax(case, train):
    make, x = _contrib_cases()[case]
    jblock, tblock = make("jax"), make("torch")
    if jblock.collect_params():
        jblock.initialize(init=mx.initializer.Xavier())
        with jag.predict_mode():
            jblock(mx.nd.array(x))
        _carry(jblock, tblock)
    if train:
        with jag.record():
            j = jblock(mx.nd.array(x))
        with ag.record():
            t = tblock(torch.tensor(x))
    else:
        j, t = jblock(mx.nd.array(x)), tblock(torch.tensor(x))
    want = j.asnumpy()
    assert tuple(t.shape) == want.shape
    tol = 0 if case == "Identity" else \
        1e-5 * max(1.0, np.abs(want).max())
    np.testing.assert_allclose(t.detach().numpy(), want, rtol=0, atol=tol)
    if case == "SparseEmbedding":
        assert tblock.weight._mx_grad_stype == "row_sparse"
        assert list(tblock.collect_params().values())[0].grad_stype == \
            jblock.weight._grad_stype == "row_sparse"
    if case == "SyncBatchNorm" and train:
        for tp, jp in zip(tblock.collect_params().values(),
                          jblock.collect_params().values()):
            np.testing.assert_allclose(tp.data().numpy(),
                                       jp.data().asnumpy(), atol=1e-6)


@pytest.mark.parametrize("factor", [2, (2, 1)])
def test_pixel_shuffle_2d(factor):
    """Against MXNet's definition in numpy: the JAX layer passes its
    shapes to ``F.reshape`` positionally, which its ``mx.nd`` takes for
    a tensor input, so it cannot run."""
    x = np.random.RandomState(4).randn(2, 8, 3, 5).astype(np.float32)
    f1, f2 = (factor,) * 2 if isinstance(factor, int) else factor
    n, c, h, w = x.shape
    want = x.reshape(n, c // (f1 * f2), f1, f2, h, w) \
        .transpose(0, 1, 4, 2, 5, 3).reshape(n, c // (f1 * f2), h * f1,
                                             w * f2)
    got = tcnn.PixelShuffle2D(factor)(torch.tensor(x))
    np.testing.assert_array_equal(got.numpy(), want)
    with pytest.raises(mx.base.MXNetError, match="tuple"):
        jcnn.PixelShuffle2D(factor)(mx.nd.array(x))


def test_sync_batchnorm_refuses_several_devices():
    with pytest.raises(ValueError, match="one card"):
        tcnn.SyncBatchNorm(in_channels=4, num_devices=2, device="cpu")


# -- contrib.tensorboard ------------------------------------------------------
def _records(path):
    out = []
    with open(path, "rb") as f:
        while True:
            hdr = f.read(8)
            if len(hdr) < 8:
                return out
            (length,) = struct.unpack("<Q", hdr)
            (hcrc,) = struct.unpack("<I", f.read(4))
            assert hcrc == ttb._masked_crc(hdr)
            data = f.read(length)
            (dcrc,) = struct.unpack("<I", f.read(4))
            assert dcrc == ttb._masked_crc(data)
            out.append(data)


def test_tensorboard_records_equal_the_jax_writers(tmp_path, monkeypatch):
    monkeypatch.setattr(time, "time", lambda: 1700000000.25)
    paths = []
    for lib, tb in (("jax", jtb), ("torch", ttb)):
        with tb.SummaryWriter(str(tmp_path / lib)) as sw:
            for step, (tag, v) in enumerate([("train/loss", 0.25),
                                             ("train/acc", 0.75),
                                             ("val/loss", -1e-3)]):
                sw.add_scalar(tag, v, step)
            sw.add_scalar("lr", 1e-4, 7, walltime=12.5)
        paths.append(sw.path)
    jrec, trec = _records(paths[0]), _records(paths[1])
    assert len(trec) == 5 and trec == jrec
    with open(paths[0], "rb") as a, open(paths[1], "rb") as b:
        assert a.read() == b.read()


def test_log_metrics_callback_writes_the_metric(tmp_path):
    from mxnet_tpu_torch.model import BatchEndParam

    metric = tmx.metric.Accuracy()
    metric.update([torch.tensor([0.0, 1.0])],
                  [torch.tensor([[0.9, 0.1], [0.2, 0.8]])])
    cb = ttb.LogMetricsCallback(str(tmp_path), prefix="val")
    cb(BatchEndParam(epoch=0, nbatch=1, eval_metric=metric, locals=None))
    cb.summary_writer.close()
    recs = _records(cb.summary_writer.path)
    assert len(recs) == 2
    assert b"val-accuracy" in recs[1]
    assert struct.pack("<f", 1.0) in recs[1]
