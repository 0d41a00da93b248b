"""The port's Gluon losses against the JAX package's classes, on the
CPU: each of the nine losses of ``gluon/loss.py`` ported with the
Wide & Deep slice, at its default arguments and at others, with and
without ``sample_weight``, on numpy-seeded inputs. The per-sample
losses and the gradients to the prediction agree within 1e-6 relative
and absolute (the same float32 expressions; XLA fuses them into other
roundings).
"""
import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
from mxnet_tpu import autograd as jag
from mxnet_tpu.gluon import loss as jloss
import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import autograd as ag
from mxnet_tpu_torch import nd
from mxnet_tpu_torch.gluon import loss as tloss

torch.set_num_threads(1)

TOL = 1e-6


def _inputs(rs, kind):
    pred = rs.randn(4, 5).astype(np.float32)
    if kind == "binary":
        label = rs.randint(0, 2, (4, 5)).astype(np.float32)
    elif kind == "signed":
        label = rs.randint(0, 2, (4, 5)).astype(np.float32) * 2 - 1
    elif kind == "prob":
        label = rs.rand(4, 5).astype(np.float32)
        label /= label.sum(1, keepdims=True)
        pred = np.log(rs.rand(4, 5).astype(np.float32) + 0.1)
    elif kind == "sigmoid":
        pred = 1 / (1 + np.exp(-pred))
        label = rs.randint(0, 2, (4, 5)).astype(np.float32)
    else:
        label = rs.randn(4, 5).astype(np.float32)
    return [pred, label]


CASES = [
    ("L1Loss", {}, "real"),
    ("L1Loss", {"weight": 0.5}, "real"),
    ("SigmoidBinaryCrossEntropyLoss", {}, "binary"),
    ("SigmoidBinaryCrossEntropyLoss", {"from_sigmoid": True}, "sigmoid"),
    ("SigmoidBinaryCrossEntropyLoss", {"pos_weight": 2.0}, "binary"),
    ("KLDivLoss", {}, "prob"),
    ("KLDivLoss", {"from_logits": False}, "prob"),
    ("HuberLoss", {}, "real"),
    ("HuberLoss", {"rho": 0.5}, "real"),
    ("HingeLoss", {}, "signed"),
    ("SquaredHingeLoss", {"margin": 2}, "signed"),
    ("LogisticLoss", {}, "signed"),
    ("LogisticLoss", {"label_format": "binary"}, "binary"),
    ("TripletLoss", {}, "triplet"),
    ("CosineEmbeddingLoss", {"margin": 0.2}, "cosine"),
]


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("name,kw,kind", CASES)
def test_loss_matches_jax(name, kw, kind, weighted):
    rs = np.random.RandomState(CASES.index((name, kw, kind)))
    kw = dict(kw)
    extra = {}
    if "pos_weight" in kw:
        extra["pos_weight"] = np.full((4, 5), kw.pop("pos_weight"),
                                      np.float32)
    if kind == "triplet":
        args = [rs.randn(4, 5).astype(np.float32) for _ in range(3)]
    elif kind == "cosine":
        args = [rs.randn(4, 5).astype(np.float32) for _ in range(2)] + [
            np.array([1, -1, 1, -1], np.float32)]
    else:
        args = _inputs(rs, kind)
    if weighted:
        # per sample: broadcast over the 5 columns, or one a loss value
        shape = (4,) if kind in ("cosine", "triplet") else (4, 1)
        extra["sample_weight"] = rs.rand(*shape).astype(np.float32)
    res = []
    for mod, arr, autograd in ((jloss, jmx.nd.array, jag),
                               (tloss, nd.array, ag)):
        with (tmx.cpu() if mod is tloss else jmx.cpu()):
            xs = [arr(a) for a in args]
            xs[0].attach_grad()
            # sample_weight, then pos_weight, by position (the JAX
            # block's call takes no keywords)
            more = [None if extra.get(k) is None else arr(extra[k])
                    for k in ("sample_weight", "pos_weight")]
            while more and more[-1] is None:
                more.pop()
            with autograd.record():
                out = getattr(mod, name)(**kw)(*xs, *more)
            out.backward()
            res.append((out.asnumpy(), xs[0].grad.asnumpy()))
    (jout, jgrad), (tout, tgrad) = res
    assert tout.shape == jout.shape == (4,)
    np.testing.assert_allclose(tout, jout, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(tgrad, jgrad, rtol=TOL, atol=TOL)
