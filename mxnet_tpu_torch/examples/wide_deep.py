#!/usr/bin/env python
"""Wide & Deep CTR training, the port's copy of ``example/wide_deep.py``:
Criteo-shaped synthetic data (50 wide multi-hot ids a row, 26
categorical fields, 13 continuous features), ``wide_deep()`` at the
model zoo's widths, Adam, ``net.hybridize()``.

    python -m mxnet_tpu_torch.examples.wide_deep           # on the card
    python -m mxnet_tpu_torch.examples.wide_deep --device cpu --quick

The defaults are the JAX example's: wide_dim 100000, 26 fields of
10000 ids, embed_dim 16, MLP 256-128-64-2, batch 1024, Adam lr 1e-3,
100000 examples, 3 epochs (``--quick``: 8192 examples, 2 epochs,
wide_dim 5000, fields of 500). The data is the example's
``synthetic_criteo`` from ``--seed`` (the example's own seed is 0),
made once and kept on the device; each batch is a slice of it.
:func:`build`, :func:`synthetic_batch` and :func:`train_step` are the
building blocks ``chip_smoke.py`` and the tests drive.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from .. import autograd, gluon, initializer, metric
from ..context import resolve_device
from ..gluon.model_zoo.wide_deep import wide_deep

__all__ = ["N_CONT", "N_FIELDS", "N_WIDE", "build", "main", "parse_args",
           "synthetic_batch", "synthetic_criteo", "train_step"]

N_WIDE, N_FIELDS, N_CONT = 50, 26, 13


def synthetic_criteo(n, wide_dim, n_wide, n_fields, field_dim, n_cont,
                     seed=0):
    """The JAX example's data: uniform wide and field ids (int32),
    uniform continuous features, and a label that depends on a
    projection of the continuous features and on the count of "magic"
    wide ids (those below ``wide_dim // 50``)."""
    rs = np.random.RandomState(seed)
    wx = rs.randint(0, wide_dim, (n, n_wide)).astype(np.int32)
    cx = rs.randint(0, field_dim, (n, n_fields)).astype(np.int32)
    ct = rs.rand(n, n_cont).astype(np.float32)
    proj = rs.randn(n_cont).astype(np.float32)
    score = ct @ proj + (wx < wide_dim // 50).sum(1) * 0.3
    y = (score > np.median(score)).astype(np.float32)
    return wx, cx, ct, y


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--batch-size", type=int, default=1024)
    ap.add_argument("--epochs", type=int, default=3)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--examples", type=int, default=100000)
    ap.add_argument("--wide-dim", type=int, default=100000)
    ap.add_argument("--field-dim", type=int, default=10000)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    ap.add_argument("--quick", action="store_true")
    args = ap.parse_args(argv)
    if args.quick:
        args.examples, args.epochs = 8192, 2
        args.wide_dim, args.field_dim = 5000, 500
    return args


def build(device, wide_dim=100000, field_dim=10000, num_fields=N_FIELDS,
          embed_dim=16, lr=1e-3, seed=0, fused_fields=True, hybridize=True,
          num_classes=2, hidden_units=(256, 128, 64)):
    """``wide_deep()`` with Xavier weights from ``seed`` (hybridized
    unless asked not to), its loss (softmax cross-entropy, or sigmoid
    cross-entropy for ``num_classes=1``) and a ``Trainer`` with Adam."""
    net = wide_deep(wide_dim=wide_dim, num_fields=num_fields,
                    field_dim=field_dim, embed_dim=embed_dim,
                    fused_fields=fused_fields, num_classes=num_classes,
                    hidden_units=hidden_units, device=device)
    net.initialize(init=initializer.Xavier(), seed=seed)
    if hybridize:
        net.hybridize()
    loss_fn = gluon.loss.SoftmaxCrossEntropyLoss() if num_classes > 1 \
        else gluon.loss.SigmoidBinaryCrossEntropyLoss()
    trainer = gluon.Trainer(net.collect_params(), "adam",
                            {"learning_rate": lr})
    return net, loss_fn, trainer


def synthetic_batch(batch_size, wide_dim, field_dim, seed, device):
    """One batch of ``synthetic_criteo`` from ``seed`` as tensors on
    ``device``: (wide ids, field ids, continuous, labels)."""
    arrays = synthetic_criteo(batch_size, wide_dim, N_WIDE, N_FIELDS,
                              field_dim, N_CONT, seed)
    return tuple(torch.from_numpy(a).to(device) for a in arrays)


def train_step(net, loss_fn, trainer, batch):
    """``record`` -> forward -> per-sample loss -> ``backward`` ->
    ``trainer.step(batch)``; returns (output, per-sample loss)."""
    wx, cx, ct, y = batch
    with autograd.record():
        out = net(wx, cx, ct)
        loss = loss_fn(out, y)
    autograd.backward(loss)
    trainer.step(wx.shape[0])
    return out, loss


def main(argv=None):
    args = parse_args(argv)
    dev = resolve_device(args.device)
    net, loss_fn, trainer = build(dev, args.wide_dim, args.field_dim,
                                  lr=args.lr, seed=args.seed)
    data = [torch.from_numpy(a).to(dev) for a in synthetic_criteo(
        args.examples, args.wide_dim, N_WIDE, N_FIELDS, args.field_dim,
        N_CONT, args.seed)]
    acc = metric.Accuracy()
    bs = args.batch_size
    for epoch in range(args.epochs):
        acc.reset()
        tic = time.perf_counter()
        for i in range(0, args.examples - bs + 1, bs):
            batch = [a[i:i + bs] for a in data]
            out, _ = train_step(net, loss_fn, trainer, batch)
            acc.update([batch[3]], [out])
        name, value = acc.get()
        dt = time.perf_counter() - tic
        print(f"epoch {epoch}: {name}={value:.4f} "
              f"{(args.examples // bs) * bs / dt:.1f} examples/s")
    return value


if __name__ == "__main__":
    main()
