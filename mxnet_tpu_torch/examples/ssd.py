#!/usr/bin/env python
"""SSD-300 over a VGG-16 trunk, trained on RecordIO scenes through
``ImageDetIter``, as MXNet users train detectors.

    python -m mxnet_tpu_torch.examples.ssd                  # on the card
    python -m mxnet_tpu_torch.examples.ssd --device cpu --quick

The network (:func:`build`) is the canonical MXNet SSD (upstream
``example/ssd/symbol/symbol_factory.py``, ``get_config("vgg16_reduced",
300)``; Liu et al. 2016, arXiv:1512.02325, section 3), written as
``HybridBlock``s over the model zoo's VGG-16:

- the trunk is ``vgg16().features``' children up to ``relu4_3``, with
  pool3 as ``MaxPool2D(2, 2, ceil_mode=True)`` (75 -> 38); then pool4,
  conv5, pool5 as ``MaxPool2D(3, 1, padding=1)``, fc6 as a 3x3
  convolution of 1024 channels at dilation 6 and fc7 as a 1x1 of 1024;
- ``relu4_3`` is ``L2Normalization(mode="channel")`` times a learned
  per-channel scale, initialised to 20;
- four extra stages (a 1x1 convolution at half the width, then a 3x3 of
  512/s2/p1, 256/s2/p1, 256/s1/p0, 256/s1/p0) give the six maps of 38,
  19, 10, 5, 3 and 1 cells;
- a 3x3 class head and a 3x3 box head per map, and ``MultiBoxPrior``
  anchors with upstream's sizes, ratios and steps: 8732 anchors.

``div`` divides every width (the CPU tests build it at ``div=16``; the
anchors stay 8732). :func:`build` takes the package (``mxnet_tpu_torch``
or the JAX package), so one definition runs in both; weights are
Xavier from the seed (the scale 20), no pretrained weights.

Training is ``example/ssd_detection.py``'s loop and losses
(:func:`train_step`; :func:`forward_backward` without the update):
``MultiBoxTarget`` under ``autograd.pause()`` (overlap 0.5,
hard-negative mining at ratio 3 below IoU 0.5, ignore -1, variances
0.1, 0.1, 0.2, 0.2), ``SoftmaxCrossEntropyLoss`` over
the class predictions plus ``smooth_l1`` over the masked offsets, SGD
at upstream's lr 0.004, momentum 0.9, wd 5e-4. Mined-out anchors
(-1) go through ``pick``'s clip to class 0, as in the JAX package.
Evaluation (:func:`detect`) is softmax plus ``MultiBoxDetection`` at
upstream's deploy settings: threshold 0.01, NMS 0.45, top 400.

The data (:func:`synthetic_scenes`, :func:`write_rec`) are seeded
scenes of 1 to 6 rectangles of 20 classes on noise, packed as im2rec
detection records (``[2, 5, cls, x1, y1, x2, y2, ...]``) in an indexed
``.rec``; :func:`det_iter` reads them back through ``ImageDetIter``
with ``CreateDetAugmenter``'s random crop, random pad, mirror, mean and
std.
"""
from __future__ import annotations

import argparse
import os
import tempfile
import time

import numpy as np

__all__ = ["ANCHORS", "MAPS", "RATIOS", "SIZES", "STEPS", "anchors", "build",
           "det_iter", "detect", "forward_backward", "main", "make_trainer",
           "synthetic_scenes", "train_step", "write_rec"]

SIZES = ((0.1, 0.141), (0.2, 0.272), (0.37, 0.447), (0.54, 0.619),
         (0.71, 0.79), (0.88, 0.961))
RATIOS = ((1.0, 2.0, 0.5),) + ((1.0, 2.0, 0.5, 3.0, 1.0 / 3),) * 3 \
    + ((1.0, 2.0, 0.5),) * 2
STEPS = tuple(s / 300.0 for s in (8, 16, 32, 64, 100, 300))
# (width, stride, pad) of the four extra stages' 3x3 convolutions
EXTRAS = ((512, 2, 1), (256, 2, 1), (256, 1, 0), (256, 1, 0))
MAPS = (38, 19, 10, 5, 3, 1)           # each map's cells a side at 300
ANCHORS = 8732
SGD = {"learning_rate": 0.004, "momentum": 0.9, "wd": 5e-4}
TARGET = {"overlap_threshold": 0.5, "negative_mining_ratio": 3.0,
          "negative_mining_thresh": 0.5, "ignore_label": -1.0,
          "variances": (0.1, 0.1, 0.2, 0.2)}
DEPLOY = {"threshold": 0.01, "nms_threshold": 0.45, "nms_topk": 400}


def build(mx, classes=20, div=1):
    """SSD-300 of ``mx`` (the package) for ``classes`` foreground
    classes, every width divided by ``div``; ``net(x)`` gives (anchors
    (1, 8732, 4), class predictions (B, classes + 1, 8732), box
    predictions (B, 8732 * 4)). Build it inside ``with mx.cpu():`` to
    place it on the CPU."""
    nn = mx.gluon.nn
    vgg = mx.gluon.model_zoo.vision.vgg
    layers, filters = vgg.vgg_spec[16]
    widths = [f // div for f in filters]
    fc = 1024 // div

    class SSD300(mx.gluon.HybridBlock):
        def __init__(self, **kwargs):
            super().__init__(**kwargs)
            self.classes = classes
            feats = list(vgg.VGG(layers, widths).features)
            with self.name_scope():
                # the VGG layers keep their own names (conv2d0_, ...):
                # their containers' prefixes keep them apart from this
                # scope's layers
                self.stage4 = nn.HybridSequential(prefix="stage4_")
                self.stage4.add(*feats[:16],
                                nn.MaxPool2D(2, 2, ceil_mode=True),
                                *feats[17:23])
                self.stage5 = nn.HybridSequential(prefix="stage5_")
                self.stage5.add(
                    *feats[23:30], nn.MaxPool2D(3, 1, padding=1),
                    nn.Conv2D(fc, 3, padding=6, dilation=6,
                              in_channels=widths[4], activation="relu"),
                    nn.Conv2D(fc, 1, in_channels=fc, activation="relu"))
                self.conv4_3_scale = self.params.get(
                    "conv4_3_scale", shape=(1, widths[3], 1, 1),
                    init=mx.init.Constant(20.0))
                self.extras = nn.HybridSequential(prefix="")
                chans = [widths[3], fc]
                for width, stride, pad in EXTRAS:
                    w = width // div
                    blk = nn.HybridSequential(prefix="")
                    blk.add(nn.Conv2D(w // 2, 1, in_channels=chans[-1],
                                      activation="relu"),
                            nn.Conv2D(w, 3, strides=stride, padding=pad,
                                      in_channels=w // 2,
                                      activation="relu"))
                    self.extras.add(blk)
                    chans.append(w)
                self.cls_heads = nn.HybridSequential(prefix="")
                self.box_heads = nn.HybridSequential(prefix="")
                for c, sizes, ratios in zip(chans, SIZES, RATIOS):
                    a = len(sizes) + len(ratios) - 1
                    self.cls_heads.add(nn.Conv2D(a * (classes + 1), 3,
                                                 padding=1, in_channels=c))
                    self.box_heads.add(nn.Conv2D(a * 4, 3, padding=1,
                                                 in_channels=c))

        def hybrid_forward(self, F, x, conv4_3_scale):
            f4 = self.stage4(x)
            maps = [F.broadcast_mul(F.L2Normalization(f4, mode="channel"),
                                    conv4_3_scale)]
            y = self.stage5(f4)
            maps.append(y)
            for blk in self.extras:
                y = blk(y)
                maps.append(y)
            anchors, cls, box = [], [], []
            for i, m in enumerate(maps):
                anchors.append(F.contrib.MultiBoxPrior(
                    m, sizes=SIZES[i], ratios=RATIOS[i],
                    steps=(STEPS[i], STEPS[i])))
                cls.append(F.Flatten(F.transpose(self.cls_heads[i](m),
                                                 axes=(0, 2, 3, 1))))
                box.append(F.Flatten(F.transpose(self.box_heads[i](m),
                                                 axes=(0, 2, 3, 1))))
            cls = F.reshape(F.concat(*cls, dim=1),
                            shape=(0, -1, self.classes + 1))
            return (F.concat(*anchors, dim=1),
                    F.transpose(cls, axes=(0, 2, 1)),
                    F.concat(*box, dim=1))

    return SSD300()


def anchors(mx, device=None):
    """The network's 8732 anchors (1, 8732, 4), made by ``MultiBoxPrior``
    over maps of :data:`MAPS` cells on ``device``."""
    import torch
    from mxnet_tpu_torch.context import resolve_device

    dev = resolve_device(device)
    return torch.cat([mx.nd.contrib.MultiBoxPrior(
        torch.zeros(1, 1, h, h, device=dev), sizes=s, ratios=r,
        steps=(st, st)) for h, s, r, st in zip(MAPS, SIZES, RATIOS, STEPS)],
        1)


def make_trainer(mx, net):
    """``SoftmaxCrossEntropyLoss`` and a ``Trainer`` with upstream's SGD."""
    return (mx.gluon.loss.SoftmaxCrossEntropyLoss(),
            mx.gluon.Trainer(net.collect_params(), "sgd", dict(SGD)))


def forward_backward(mx, net, loss_fn, x, label):
    """``example/ssd_detection.py``'s step without the update: record,
    forward, ``MultiBoxTarget`` under ``pause``, class + box losses,
    backward. Returns (loss, class loss, box loss)."""
    nd = mx.nd
    with mx.autograd.record():
        anchors, cls_p, loc_p = net(x)
        with mx.autograd.pause():
            loc_t, loc_m, cls_t = nd.contrib.MultiBoxTarget(
                anchors, label, cls_p, **TARGET)
        lc = nd.mean(loss_fn(nd.transpose(cls_p, axes=(0, 2, 1)), cls_t))
        ll = nd.mean(nd.smooth_l1((loc_p - loc_t) * loc_m, scalar=1.0))
        loss = lc + ll
    loss.backward()
    return loss, lc, ll


def train_step(mx, net, loss_fn, trainer, x, label):
    """:func:`forward_backward`, then ``trainer.step(batch)``."""
    out = forward_backward(mx, net, loss_fn, x, label)
    trainer.step(x.shape[0])
    return out


def detect(mx, net, x):
    """Softmax and ``MultiBoxDetection`` at the deploy settings:
    (B, 8732, 6) rows [class, score, x1, y1, x2, y2], -1 when pruned."""
    with mx.autograd.predict_mode():
        anchors, cls_p, loc_p = net(x)
    return mx.nd.contrib.MultiBoxDetection(
        mx.nd.softmax(cls_p, axis=1), loc_p, anchors, **DEPLOY)


def synthetic_scenes(n, size=300, classes=20, seed=0):
    """``n`` HWC uint8 scenes of 1 to 6 filled rectangles (each class its
    own colour; sides from a tenth to 95% of the image, so every map's
    anchors find objects, the largest painted first) on noise, and their
    (k, 5) labels [cls, x1, y1, x2, y2] normalized to [0, 1]."""
    rs = np.random.RandomState(seed)
    colours = rs.randint(0, 256, (classes, 3))
    images, labels = [], []
    for _ in range(n):
        img = rs.randint(0, 64, (size, size, 3)).astype(np.uint8)
        k = rs.randint(1, 7)
        wh = rs.randint(size // 10, int(size * 0.95), (k, 2))
        wh = wh[np.argsort(-wh.prod(1), kind="stable")]
        lab = np.zeros((k, 5), np.float32)
        for j, (w, h) in enumerate(wh):
            x0, y0 = rs.randint(0, size - w), rs.randint(0, size - h)
            c = rs.randint(classes)
            img[y0:y0 + h, x0:x0 + w] = colours[c]
            lab[j] = [c, x0 / size, y0 / size, (x0 + w) / size,
                      (y0 + h) / size]
        images.append(img)
        labels.append(lab)
    return images, labels


def write_rec(mx, path, images, labels):
    """An indexed ``.rec`` (``.idx`` beside it) of the scenes as im2rec
    detection records; returns (rec path, idx path)."""
    idx = os.path.splitext(path)[0] + ".idx"
    rec = mx.recordio.MXIndexedRecordIO(idx, path, "w")
    for i, (img, lab) in enumerate(zip(images, labels)):
        header = mx.recordio.IRHeader(
            0, np.concatenate([[2.0, 5.0], lab.ravel()]).astype(np.float32),
            i, 0)
        rec.write_idx(i, mx.recordio.pack_img(header, img, img_fmt=".png"))
    rec.close()
    return path, idx


def det_iter(mx, path, batch_size, size=300, ctx=None, seed=0,
             label_shape=(8, 5)):
    """``ImageDetIter`` over the ``.rec`` (shuffled): random crop and pad
    (each at probability 0.5), mirror, ImageNet mean and std, batches
    of ``batch_size`` x 3 x ``size`` x ``size`` on ``ctx``."""
    np.random.seed(seed)
    return mx.image.ImageDetIter(
        batch_size, (3, size, size), path_imgrec=path,
        path_imgidx=os.path.splitext(path)[0] + ".idx", shuffle=True,
        rand_crop=0.5, rand_pad=0.5, rand_mirror=True, mean=True, std=True,
        label_shape=label_shape, ctx=ctx)


def main(argv=None):
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.context import resolve_device

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--batch-size", type=int, default=32)
    ap.add_argument("--images", type=int, default=256)
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--div", type=int, default=1,
                    help="divide every width by this")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    ap.add_argument("--quick", action="store_true")
    args = ap.parse_args(argv)
    if args.quick:
        args.batch_size, args.images, args.steps, args.div = 4, 16, 4, 16
    dev = resolve_device(args.device)
    ctx = mx.Context.of(dev)
    images, labels = synthetic_scenes(args.images, seed=args.seed)
    with tempfile.TemporaryDirectory() as tmp:
        path, _ = write_rec(mx, os.path.join(tmp, "scenes.rec"), images,
                            labels)
        it = det_iter(mx, path, args.batch_size, ctx=ctx, seed=args.seed)
        with ctx:
            mx.random.seed(args.seed)
            net = build(mx, div=args.div)
            net.initialize(init=mx.init.Xavier(), seed=args.seed)
        loss_fn, trainer = make_trainer(mx, net)
        step = 0
        tic = time.perf_counter()
        while step < args.steps:
            try:
                batch = it.next()
            except StopIteration:
                it.reset()
                continue
            loss, lc, ll = train_step(mx, net, loss_fn, trainer,
                                      batch.data[0], batch.label[0])
            print(f"step {step}: loss {float(loss):.4f} (class "
                  f"{float(lc):.4f}, box {float(ll):.4f})")
            step += 1
        dt = time.perf_counter() - tic
        det = detect(mx, net, batch.data[0]).asnumpy()
    kept = (det[:, :, 0] >= 0).sum(1)
    print(f"{args.steps * args.batch_size / dt:.1f} images/s; detections "
          f"per image {kept.tolist()}")
    return float(loss)


if __name__ == "__main__":
    main()
