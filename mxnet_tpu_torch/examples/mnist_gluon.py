#!/usr/bin/env python
"""Gluon MNIST training, the port's copy of ``example/mnist_gluon.py``
(the MNIST tutorial loop): Flatten -> Dense(256, relu) -> Dense(128,
relu) -> Dense(10), Xavier weights, Adam at lr 1e-3, a shuffled
``DataLoader`` over the example's synthetic MNIST-shaped data (60000
samples; each label the argmax of a fixed random projection).

    python -m mxnet_tpu_torch.examples.mnist_gluon            # on the card
    python -m mxnet_tpu_torch.examples.mnist_gluon --device cpu --quick

Run as a script it fails unless the final accuracy passes 0.8, as the
JAX example does. ``--save`` waits for parameter files (ROADMAP Queue
1, 'Parameter files') and raises. :func:`train` is the loop
``chip_smoke.py`` and the tests drive.
"""
from __future__ import annotations

import argparse
import sys
import time

import numpy as np

from .. import autograd, gluon, initializer, metric
from ..context import resolve_device
from ..gluon import nn

__all__ = ["build", "main", "parse_args", "synthetic_mnist", "train"]


def synthetic_mnist(n):
    """(n, 1, 28, 28) uniform images and float32 labels: the JAX
    example's data, bit for bit."""
    rs = np.random.RandomState(0)
    w = rs.randn(784, 10).astype(np.float32)
    x = rs.rand(n, 1, 28, 28).astype(np.float32)
    y = (x.reshape(n, -1) @ w).argmax(1).astype(np.float32)
    return x, y


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--epochs", type=int, default=5)
    ap.add_argument("--batch-size", type=int, default=64)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--save", default=None, help="checkpoint prefix")
    args = ap.parse_args(argv)
    if args.save:
        raise NotImplementedError(
            "--save: parameter files are not ported yet (ROADMAP Queue 1, "
            "'Parameter files')")
    args.samples = 512 if args.quick else 60000
    if args.quick:
        args.epochs = min(args.epochs, 2)
    return args


def build(device, seed=0):
    """The MLP, Xavier weights from ``seed``; Gluon's names
    ``dense0_weight`` ... ``dense2_bias``."""
    net = nn.HybridSequential()
    net.add(nn.Flatten(),
            nn.Dense(256, activation="relu", in_units=784, prefix="dense0_",
                     device=device),
            nn.Dense(128, activation="relu", in_units=256, prefix="dense1_",
                     device=device),
            nn.Dense(10, in_units=128, prefix="dense2_", device=device))
    net.initialize(init=initializer.Xavier(), seed=seed)
    net.hybridize()
    return net


def train(args):
    """The example's loop; returns ``{"accuracy", "epochs": [{"loss",
    "accuracy", "seconds", "samples_per_s"}, ...]}``."""
    dev = resolve_device(args.device)
    x, y = synthetic_mnist(args.samples)
    loader = gluon.data.DataLoader(
        gluon.data.ArrayDataset(x, y), batch_size=args.batch_size,
        shuffle=True, device=dev, rng=np.random.default_rng(args.seed))
    net = build(dev, args.seed)
    loss_fn = gluon.loss.SoftmaxCrossEntropyLoss()
    trainer = gluon.Trainer(net.collect_params(), "adam",
                            {"learning_rate": args.lr})
    acc = metric.Accuracy()
    epochs = []
    for epoch in range(args.epochs):
        acc.reset()
        tic = time.perf_counter()
        total_loss, batches = 0.0, 0
        for xb, yb in loader:
            with autograd.record():
                out = net(xb)
                loss = loss_fn(out, yb)
            autograd.backward(loss)
            trainer.step(xb.shape[0])
            acc.update([yb], [out])
            total_loss += float(loss.detach().mean())
            batches += 1
        dt = time.perf_counter() - tic
        name, value = acc.get()
        epochs.append({"loss": total_loss / batches, "accuracy": value,
                       "seconds": dt, "samples_per_s": len(x) / dt})
        print(f"epoch {epoch}: loss={total_loss / batches:.4f} "
              f"{name}={value:.4f} ({len(x) / dt:.1f} samples/s)")
    return {"accuracy": value, "epochs": epochs}


def main(argv=None):
    return train(parse_args(argv))["accuracy"]


if __name__ == "__main__":
    final_acc = main()
    if not final_acc > 0.8:
        sys.exit(f"did not converge: {final_acc}")
