#!/usr/bin/env python
"""ResNet ImageNet-style training, the port's copy of
``example/train_imagenet.py``: a model-zoo ResNet, SGD with momentum
and weight decay, synthetic resident batches, bf16 compute.

    python -m mxnet_tpu_torch.examples.train_imagenet        # on the card
    python -m mxnet_tpu_torch.examples.train_imagenet --device cpu --quick

The defaults are the JAX example's: ``resnet50_v1``, 1000 classes,
batch 128 of 224 x 224, SGD lr 0.1, momentum 0.9, wd 1e-4, 50 steps,
``--dtype bfloat16`` (``net.cast``: BatchNorm keeps float32
statistics). Without ``--data-train`` the batch is one synthetic
ImageNet-shaped batch, uniform [0, 1) images and uniform labels from
``--seed``, fed each step. With ``--data-train train.rec`` (and its
``train.idx`` beside it) the batches come from ``io.ImageRecordIter``:
shuffled, random crops of ``--image-shape`` and mirrors, normalized by
the ImageNet mean and std, each batch one copy to the device;
``--data-val`` adds a center-crop accuracy pass after each epoch.
Several devices (``--num-devices``) and the ``dist`` key-value stores
are not ported yet and raise. :func:`build`, :func:`synthetic_batch`,
:func:`record_iter` and :func:`train_step` are the building blocks
``chip_smoke.py`` and the tests drive.
"""
from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch

from .. import autograd, gluon, initializer, io, metric
from ..context import resolve_device
from ..gluon.model_zoo import vision

__all__ = ["build", "main", "parse_args", "record_iter", "synthetic_batch",
           "train_step"]


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
                    help=".rec file with its .idx beside it (synthetic "
                         "batches if absent)")
    ap.add_argument("--data-val", default=None,
                    help=".rec file for a center-crop accuracy pass after "
                         "each epoch")
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


MEAN_RGB = (123.68, 116.28, 103.53)
STD_RGB = (58.395, 57.12, 57.375)


def record_iter(path, batch_size, image, device, train=True, seed=0):
    """``io.ImageRecordIter`` over ``path`` (its ``.idx`` beside it):
    ``image`` x ``image`` crops (random and mirrored for training,
    centered otherwise), normalized by the ImageNet mean and std, each
    batch on ``device``. ``seed`` seeds numpy's generator, which the
    shuffle and the augmenters draw from."""
    np.random.seed(seed)
    idx = os.path.splitext(path)[0] + ".idx"
    return io.ImageRecordIter(
        path_imgrec=path, path_imgidx=idx if os.path.exists(idx) else None,
        data_shape=(3, image, image), batch_size=batch_size, shuffle=train,
        rand_crop=train, rand_mirror=train, mean_r=MEAN_RGB[0],
        mean_g=MEAN_RGB[1], mean_b=MEAN_RGB[2], std_r=STD_RGB[0],
        std_g=STD_RGB[1], std_b=STD_RGB[2], ctx=device)


def _record_batches(it, steps, dtype):
    """``steps`` batches of ``it`` (reset at its end) as tensors."""
    done = 0
    while done < steps:
        try:
            batch = it.next()
        except StopIteration:
            it.reset()
            continue
        x = batch.data[0].as_subclass(torch.Tensor)
        yield x.to(getattr(torch, dtype)), \
            batch.label[0].as_subclass(torch.Tensor)
        done += 1


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
    if args.data_train:
        train_it = record_iter(args.data_train, args.batch_size,
                               args.image_shape, dev, seed=args.seed)
    else:
        x, y = synthetic_batch(args.batch_size, args.image_shape,
                               args.classes, args.seed, dev, args.dtype)
    acc = metric.Accuracy()
    for epoch in range(args.epochs):
        acc.reset()
        tic = time.perf_counter()
        batches = _record_batches(train_it, args.steps_per_epoch,
                                  args.dtype) if args.data_train \
            else ((x, y) for _ in range(args.steps_per_epoch))
        for xb, yb in batches:
            out, loss = train_step(net, loss_fn, trainer, xb, yb)
            acc.update([yb], [out])
        loss = float(loss.detach().float().mean())   # waits for the device
        dt = time.perf_counter() - tic
        seen = args.steps_per_epoch * args.batch_size
        name, value = acc.get()
        line = (f"epoch {epoch}: {seen / dt:.1f} img/s {name}={value:.4f} "
                f"loss={loss:.4f}")
        if args.data_val:
            val = metric.Accuracy()
            val_it = record_iter(args.data_val, args.batch_size,
                                 args.image_shape, dev, train=False)
            with autograd.predict_mode():
                for batch in val_it:
                    n = args.batch_size - (batch.pad or 0)
                    xb = batch.data[0].as_subclass(torch.Tensor)[:n]
                    val.update([batch.label[0][:n]],
                               [net(xb.to(getattr(torch, args.dtype)))])
            line += f" val-{val.get()[0]}={val.get()[1]:.4f}"
        print(line)
    return loss


if __name__ == "__main__":
    main()
