"""The port's Wide & Deep against the JAX package's, on the CPU, and the
reference's two sparse scripts on the port.

- ``WideDeep`` in both layouts (one offset-indexed table, a table per
  field), ``sparse_grad=True`` as the model zoo builds it, the JAX
  model's weights carried by structural name: the forward within 1e-5,
  every parameter's gradient of a softmax cross-entropy step within
  1e-5, and the weights after 3 Adam steps within 1e-5 (small float32
  sums in another order: the tables' gradients sum repeated ids in id
  order in both packages). The port runs eagerly and hybridized (a
  CachedOp entry on the CPU), and the two give the same bits.
- ``num_classes=1`` trains on ``SigmoidBinaryCrossEntropyLoss`` as the
  JAX model does (same tolerances).
- ``example/wide_deep.py --quick`` and ``example/sparse_linear.py
  --quick`` run unmodified through ``run_reference --ctx cpu`` (their
  own assertions: accuracy > 0.65 and > 0.8), import neither ``jax``
  nor the JAX package, and launch no port kernel.
"""
import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
from mxnet_tpu import autograd as jag
from mxnet_tpu import gluon as jgluon
from mxnet_tpu.gluon.model_zoo.wide_deep import WideDeep as JaxWideDeep
import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import autograd as ag
from mxnet_tpu_torch import gluon, nd
from mxnet_tpu_torch.gluon.model_zoo.wide_deep import WideDeep

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parent.parent
TOL = 1e-5
WIDE, FIELDS, B = 400, [30, 20, 50, 10], 16


def _batch(seed, classes):
    rs = np.random.RandomState(seed)
    wx = rs.randint(0, WIDE, (B, 6)).astype(np.int32)
    wx[:, 0] = 7                    # one id in every row: a hot row
    cx = np.stack([rs.randint(0, d, B) for d in FIELDS], 1).astype(np.int32)
    ct = rs.rand(B, 3).astype(np.float32)
    y = rs.randint(0, max(classes, 2), B).astype(np.float32)
    return wx, cx, ct, y


def _pair(fused, classes):
    kw = dict(embed_dim=4, hidden_units=(16, 8), num_classes=classes,
              fused_fields=fused)
    jnet = JaxWideDeep(WIDE, FIELDS, **kw)
    jnet.initialize(init=jmx.initializer.Xavier())
    with tmx.cpu():
        tnet = WideDeep(WIDE, FIELDS, **kw)
        tnet.initialize()
    wx, cx, ct, _ = _batch(0, classes)
    jnet(jmx.nd.array(wx), jmx.nd.array(cx), jmx.nd.array(ct))
    with tmx.cpu():
        tnet(nd.array(wx), nd.array(cx), nd.array(ct))     # the shapes
    jp = jnet._collect_params_with_prefix()
    tp = dict(tnet.named_parameters())
    assert set(jp) == set(tp)
    for k, v in tp.items():
        with torch.no_grad():
            v.copy_(torch.tensor(jp[k].data().asnumpy()))
    return jnet, tnet


def _losses(classes):
    if classes == 1:
        return (jgluon.loss.SigmoidBinaryCrossEntropyLoss(),
                gluon.loss.SigmoidBinaryCrossEntropyLoss())
    return (jgluon.loss.SoftmaxCrossEntropyLoss(),
            gluon.loss.SoftmaxCrossEntropyLoss())


def _train(net, loss_fn, trainer, batches, arr, autograd):
    outs, grads = [], []
    for wx, cx, ct, y in batches:
        with autograd.record():
            out = net(arr(wx), arr(cx), arr(ct))
            loss = loss_fn(out, arr(y))
        loss.backward()
        outs.append(out.asnumpy())
        grads.append({k: p.grad().asnumpy().copy()
                      for k, p in net.collect_params().items()})
        trainer.step(wx.shape[0])
    return outs, grads


def _port_run(tnet, classes, batches, hybridize):
    if hybridize:
        tnet.hybridize()
    trainer = gluon.Trainer(tnet.collect_params(), "adam",
                            {"learning_rate": 0.01})
    with tmx.cpu():
        outs, grads = _train(tnet, _losses(classes)[1], trainer, batches,
                             nd.array, ag)
    weights = {k: p.data().asnumpy().copy()
               for k, p in tnet.collect_params().items()}
    return outs, grads, weights


@pytest.mark.parametrize("fused,classes", [(True, 2), (False, 2),
                                           (True, 1)])
def test_wide_deep_matches_jax_eager_and_hybridized(fused, classes):
    batches = [_batch(s, classes) for s in range(3)]
    jnet, tnet = _pair(fused, classes)
    init = {k: v.detach().clone() for k, v in tnet.named_parameters()}
    jtr = jgluon.Trainer(jnet.collect_params(), "adam",
                         {"learning_rate": 0.01})
    jouts, jgrads = _train(jnet, _losses(classes)[0], jtr, batches,
                           jmx.nd.array, jag)
    runs = []
    for hybridize in (False, True):
        with torch.no_grad():
            for k, v in tnet.named_parameters():
                v.copy_(init[k])
        runs.append(_port_run(tnet, classes, batches, hybridize))
    tparams = tnet.collect_params()
    assert {p.grad_stype for k, p in tparams.items()
            if k.endswith("_weight") and "dense" not in k} == {"row_sparse"}
    jnames = {k[len(jnet.prefix):]: k for k in jnet.collect_params()}
    assert set(jnames) == set(tparams)
    eager, graphed = runs
    for a, b in zip(eager, graphed):            # the same bits
        for x, y in zip(a if isinstance(a, list) else [a],
                        b if isinstance(b, list) else [b]):
            if isinstance(x, dict):
                for k in x:
                    np.testing.assert_array_equal(x[k], y[k], err_msg=k)
            else:
                np.testing.assert_array_equal(x, y)
    outs, grads, weights = eager
    for o, jo in zip(outs, jouts):
        np.testing.assert_allclose(o, jo, rtol=TOL, atol=TOL)
    for g, jg in zip(grads, jgrads):
        for k in g:
            np.testing.assert_allclose(g[k], jg[jnames[k]], rtol=TOL,
                                       atol=TOL, err_msg=k)
    jparams = jnet.collect_params()
    for k, w in weights.items():
        np.testing.assert_allclose(w, jparams[jnames[k]].data().asnumpy(),
                                   rtol=TOL, atol=TOL, err_msg=k)


def _start(script):
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="2")
    return subprocess.Popen(
        [sys.executable, "-m", "mxnet_tpu_torch.examples.run_reference",
         "--ctx", "cpu", script, "--quick"], cwd=str(ROOT), env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def test_reference_sparse_scripts_quick_run_on_the_port():
    """Both scripts at once, each in its own process."""
    runs = {s: _start(s) for s in ("example/wide_deep.py",
                                   "example/sparse_linear.py")}
    for script, proc in runs.items():
        stdout, stderr = proc.communicate(timeout=600)
        assert proc.returncode == 0, stdout[-2000:] + stderr[-4000:]
        key = "accuracy=" if "wide" in script else "train accuracy"
        epochs = [line for line in stdout.splitlines()
                  if line.startswith("epoch ") and key in line]
        assert len(epochs) == (2 if "wide" in script else 8)
        counts = json.loads(stdout.strip().splitlines()[-1])["launch_counts"]
        assert not any(counts.values())     # no port kernel on this path
