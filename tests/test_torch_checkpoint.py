"""The port's ``checkpoint.CheckpointManager``, mirroring the JAX
package's ``tests/test_checkpoint_manager.py`` on the CPU: periodic
saves, pruning to ``max_keep``, ``latest_step``, ``restore`` (the
resumed run continues bit for bit: same weights after the next step),
the SIGTERM-style snapshot that re-delivers the signal to the previous
handler, and the sidecar's keys against the JAX manager's. The JAX
manager's ``.params`` load into the port's net (the ``.states`` do
not: they pickle the JAX package's classes)."""
import json
import os
import signal

import numpy as np
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu import gluon as jgluon
from mxnet_tpu.checkpoint import CheckpointManager as JaxManager
from mxnet_tpu.gluon import nn as jnn
import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import autograd, gluon, nd
from mxnet_tpu_torch.checkpoint import CheckpointManager
from mxnet_tpu_torch.gluon import nn

torch.set_num_threads(1)


def _net_and_trainer(lr=0.1, seed=0):
    with tmx.cpu():
        net = nn.HybridSequential(prefix="ckn_")
        with net.name_scope():
            net.add(nn.Dense(8, activation="relu", prefix="d1_"),
                    nn.Dense(2, in_units=8, prefix="d2_"))
        net.initialize(init=tmx.init.Xavier(), seed=seed)
    trainer = gluon.Trainer(net.collect_params(), "adam",
                            {"learning_rate": lr})
    return net, trainer


def _one_step(net, trainer, i=0):
    x = nd.array(np.random.RandomState(i).randn(4, 4).astype(np.float32),
                 ctx="cpu")
    with autograd.record():
        loss = (net(x) ** 2).sum()
    loss.backward()
    trainer.step(4)


def _weights(net):
    return {k: v.data().asnumpy().copy()
            for k, v in net.collect_params().items()}


def test_periodic_save_prune_and_resume(tmp_path):
    prefix = str(tmp_path / "ck")
    net, trainer = _net_and_trainer()
    mgr = CheckpointManager(prefix, net=net, trainer=trainer, max_keep=2,
                            every_n_steps=2, signals=())
    for i in range(6):
        _one_step(net, trainer, i)
        mgr.step()
    metas = sorted(p for p in os.listdir(tmp_path)
                   if p.endswith(".meta.json"))
    assert metas == ["ck-0000004.meta.json", "ck-0000006.meta.json"], metas
    assert sorted(os.listdir(tmp_path)) == sorted(
        f"ck-000000{s}.{ext}" for s in (4, 6)
        for ext in ("params", "states", "meta.json"))
    want = _weights(net)
    net2, trainer2 = _net_and_trainer(seed=5)     # other weights to start
    mgr2 = CheckpointManager(prefix, net=net2, trainer=trainer2,
                             signals=())
    assert mgr2.latest_step() == 6
    assert mgr2.restore() == 6
    got = _weights(net2)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
    # the optimizer state came back too: the next step is bit for bit
    _one_step(net, trainer, 9)
    _one_step(net2, trainer2, 9)
    after, after2 = _weights(net), _weights(net2)
    for k in after:
        np.testing.assert_array_equal(after2[k], after[k])


def test_signal_triggered_save_re_delivers(tmp_path):
    prefix = str(tmp_path / "pe")
    net, trainer = _net_and_trainer()
    seen = []
    old = signal.signal(signal.SIGUSR1, lambda *a: seen.append(a[0]))
    mgr = CheckpointManager(prefix, net=net, trainer=trainer,
                            signals=(signal.SIGUSR1,))
    try:
        _one_step(net, trainer)
        mgr.step()
        os.kill(os.getpid(), signal.SIGUSR1)
        assert mgr.preempted
        assert seen == [signal.SIGUSR1]          # the previous handler ran
        metas = [p for p in os.listdir(tmp_path)
                 if p.endswith(".meta.json")]
        assert metas, "signal did not trigger a save"
        with open(os.path.join(tmp_path, metas[0])) as f:
            assert json.load(f)["tag"] == "preempt"
    finally:
        mgr.close()
        signal.signal(signal.SIGUSR1, old)
    assert signal.getsignal(signal.SIGUSR1) is old


def test_restore_fresh_start_and_sharded_refused(tmp_path):
    net, trainer = _net_and_trainer()
    mgr = CheckpointManager(str(tmp_path / "none"), net=net,
                            trainer=trainer, signals=())
    assert mgr.latest_step() is None
    assert mgr.restore() == 0
    with pytest.raises(ValueError, match="sharded=True"):
        CheckpointManager(str(tmp_path / "sh"), net=net, signals=(),
                          sharded=True)


def test_sidecar_keys_and_params_shared_with_the_jax_manager(tmp_path):
    jnet = jnn.HybridSequential(prefix="ckn_")
    with jnet.name_scope():
        jnet.add(jnn.Dense(8, activation="relu", in_units=4, prefix="d1_"),
                 jnn.Dense(2, in_units=8, prefix="d2_"))
    jnet.initialize(init=mx.init.Xavier())
    jtrainer = jgluon.Trainer(jnet.collect_params(), "adam")
    jmgr = JaxManager(str(tmp_path / "j"), net=jnet, trainer=jtrainer,
                      signals=())
    jmgr.step()
    jmgr.save()
    net, trainer = _net_and_trainer()
    _one_step(net, trainer)
    mgr = CheckpointManager(str(tmp_path / "t"), net=net, trainer=trainer,
                            signals=())
    mgr.step()
    mgr.save()
    with open(tmp_path / "j-0000001.meta.json") as f:
        jmeta = json.load(f)
    with open(tmp_path / "t-0000001.meta.json") as f:
        meta = json.load(f)
    assert sorted(meta) == sorted(jmeta)
    assert (meta["sharded"], meta["num_processes"]) == (False, 1)
    # the JAX manager's .params load into the port's net
    net.load_parameters(str(tmp_path / "j-0000001.params"))
    for k, v in jnet.collect_params().items():
        np.testing.assert_array_equal(
            net.collect_params()[k[len(jnet.prefix):]].data().asnumpy(),
            v.data().asnumpy())
    with pytest.raises(tmx.MXNetError, match="JAX package"):
        trainer.load_states(str(tmp_path / "j-0000001.states"))
