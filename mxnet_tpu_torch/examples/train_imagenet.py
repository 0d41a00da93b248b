#!/usr/bin/env python
"""ResNet ImageNet-style training, the port's copy of
``example/train_imagenet.py``: a model-zoo ResNet, SGD with momentum
and weight decay, synthetic resident batches, bf16 compute.

    python -m mxnet_tpu_torch.examples.train_imagenet        # on the card
    python -m mxnet_tpu_torch.examples.train_imagenet --device cpu --quick

The defaults are the JAX example's: ``resnet50_v1``, 1000 classes,
batch 128 of 224 x 224, SGD lr 0.1, momentum 0.9, wd 1e-4, 50 steps,
``--dtype bfloat16`` (``net.cast``: BatchNorm keeps float32
statistics). The batch is one synthetic ImageNet-shaped batch, uniform
[0, 1) images and uniform labels from ``--seed``, fed each step.
RecordIO input (``--data-train``), several devices (``--num-devices``)
and the ``dist`` key-value stores are not ported yet and raise.
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
from ..gluon.model_zoo import vision

__all__ = ["build", "main", "parse_args", "synthetic_batch", "train_step"]


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--network", default="resnet50_v1")
    ap.add_argument("--classes", type=int, default=1000)
    ap.add_argument("--batch-size", type=int, default=128,
                    help="global batch")
    ap.add_argument("--image-shape", type=int, default=224)
    ap.add_argument("--num-devices", type=int, default=1)
    ap.add_argument("--kv-store", default="device")
    ap.add_argument("--lr", type=float, default=0.1)
    ap.add_argument("--epochs", type=int, default=1)
    ap.add_argument("--steps-per-epoch", type=int, default=50)
    ap.add_argument("--data-train", default=None,
                    help=".rec file (not ported: synthetic data only)")
    ap.add_argument("--data-workers", type=int, default=8)
    ap.add_argument("--dtype", default="bfloat16")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    ap.add_argument("--quick", action="store_true")
    args = ap.parse_args(argv)
    if args.quick:
        args.batch_size, args.image_shape, args.classes = 16, 64, 10
        args.steps_per_epoch, args.epochs = 5, 1
        args.network, args.dtype = "resnet18_v1", "float32"
    if args.data_train:
        raise NotImplementedError(
            "--data-train: RecordIO input is not ported yet (ROADMAP "
            "Queue 1, 'Vision remainders'); the example trains on "
            "synthetic batches")
    if args.num_devices != 1 or args.kv_store.startswith("dist"):
        raise NotImplementedError(
            f"--num-devices {args.num_devices} --kv-store {args.kv_store}: "
            f"multi-GPU training is not ported yet (ROADMAP Queue 1, "
            f"'Multi-GPU')")
    return args


def build(network, classes, device, dtype="float32", seed=0, lr=0.1,
          kv_store="device"):
    """The model with Xavier weights from ``seed`` (cast to ``dtype``),
    ``SoftmaxCrossEntropyLoss`` and a ``Trainer`` with SGD (momentum
    0.9, wd 1e-4)."""
    net = vision.get_model(network, classes=classes, device=device)
    net.initialize(init=initializer.Xavier(), seed=seed)
    if dtype != "float32":
        net.cast(dtype)
    net.hybridize()
    loss_fn = gluon.loss.SoftmaxCrossEntropyLoss()
    trainer = gluon.Trainer(net.collect_params(), "sgd",
                            {"learning_rate": lr, "momentum": 0.9,
                             "wd": 1e-4}, kvstore=kv_store)
    return net, loss_fn, trainer


def synthetic_batch(batch_size, image, classes, seed, device,
                    dtype="float32"):
    """One batch: (batch, 3, image, image) uniform [0, 1) and labels
    uniform over ``classes`` (float32, as the JAX example's), from
    ``seed``."""
    rs = np.random.RandomState(seed)
    x = rs.rand(batch_size, 3, image, image).astype(np.float32)
    y = rs.randint(0, classes, batch_size).astype(np.float32)
    return (torch.from_numpy(x).to(device, getattr(torch, dtype)),
            torch.from_numpy(y).to(device))


def train_step(net, loss_fn, trainer, x, y):
    """``record`` -> forward -> per-sample loss -> ``backward`` ->
    ``trainer.step(batch)``; returns (output, per-sample loss)."""
    with autograd.record():
        out = net(x)
        loss = loss_fn(out, y)
    autograd.backward(loss)
    trainer.step(x.shape[0])
    return out, loss


def main(argv=None):
    args = parse_args(argv)
    dev = resolve_device(args.device)
    net, loss_fn, trainer = build(args.network, args.classes, dev,
                                  args.dtype, args.seed, args.lr,
                                  args.kv_store)
    x, y = synthetic_batch(args.batch_size, args.image_shape, args.classes,
                           args.seed, dev, args.dtype)
    acc = metric.Accuracy()
    for epoch in range(args.epochs):
        acc.reset()
        tic = time.perf_counter()
        for _ in range(args.steps_per_epoch):
            out, loss = train_step(net, loss_fn, trainer, x, y)
            acc.update([y], [out])
        loss = float(loss.detach().float().mean())   # waits for the device
        dt = time.perf_counter() - tic
        seen = args.steps_per_epoch * args.batch_size
        name, value = acc.get()
        print(f"epoch {epoch}: {seen / dt:.1f} img/s {name}={value:.4f} "
              f"loss={loss:.4f}")
    return loss


if __name__ == "__main__":
    main()
