#!/usr/bin/env python
"""BERT masked-LM training in mixed precision, as an MXNet 1.x user
writes it: the model zoo's BERT trunk + ``BERTMLMHead``, Adam, and
``contrib.amp``::

    amp.init("bfloat16")                 # before the model runs
    trainer = gluon.Trainer(params, "adam", {"learning_rate": 1e-4})
    amp.init_trainer(trainer)
    with autograd.record():
        loss = nd.softmax_cross_entropy(head(flat), labels)
    with amp.scale_loss(loss, trainer) as scaled:
        autograd.backward(scaled)
    trainer.step(n_valid)

    python -m mxnet_tpu_torch.examples.bert_mlm          # on the card
    python -m mxnet_tpu_torch.examples.bert_mlm --device cpu --quick
    python -m mxnet_tpu_torch.examples.bert_mlm --np --amp none

Under bfloat16 AMP the products (the QKV, output and FFN projections,
the embeddings, the decoder) run in bfloat16, so the attention kernels
(K1/K2) take bfloat16; LayerNorm (K3a/K3b) and the fused softmax
cross-entropy (K4a/K4b) stay in float32, as MXNet's op lists say.
``--amp float16`` scales the loss dynamically; ``--amp none`` trains in
float32. The batch is synthetic: rows of uniform random ids with valid
lengths uniform in [S/2, S], one label per valid position.
``chip_smoke.py`` builds, draws and steps through :func:`build`,
:func:`synthetic_arrays` and :func:`train_step`: without ``init_trainer``
``scale_loss`` passes the loss through, so its float32 paths take the
same step. ``--np`` trains under ``npx.set_np()`` and feeds ``mx.np``
arrays (``on_device(..., as_np=True)``): the outputs, the loss and the
gradients are ``mx.np.ndarray``s, the model sees plain tensors, and the
step launches the kernels the classic one does.
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from .. import autograd, gluon, nd
from .. import numpy as mnp
from .. import numpy_extension as npx
from ..context import resolve_device
from ..contrib import amp
from ..gluon.model_zoo.bert import BERTMLMHead, BERTModel

__all__ = ["build", "main", "on_device", "synthetic_arrays",
           "synthetic_batch", "train_step"]


def build(device, vocab_size=30522, units=768, hidden_size=3072,
          num_layers=12, num_heads=12, max_length=512, seed=0, lr=1e-4):
    """BERT trunk (no pooler: the MLM loss never reads it) + MLM head
    with weights from ``seed``, dropout 0, and a ``Trainer`` with Adam
    over both: ``(net, head, params, trainer)``, ``params`` by name."""
    net = BERTModel(vocab_size=vocab_size, units=units,
                    hidden_size=hidden_size, num_layers=num_layers,
                    num_heads=num_heads, max_length=max_length,
                    dropout=0.0, attention_dropout=0.0, use_pooler=False,
                    device=device, seed=seed)
    head = BERTMLMHead(vocab_size, units, device=device, seed=seed + 1)
    params = dict(net.collect_params().items())
    params.update(head.collect_params().items())
    trainer = gluon.Trainer(params, "adam", {"learning_rate": lr})
    return net, head, params, trainer


def synthetic_arrays(seed, batch, seq_len, vocab_size):
    """``(lens, ids, labels, pos)`` as numpy arrays: valid lengths
    uniform in [S/2, S], ids and labels uniform over the vocabulary, one
    label per valid position; ``pos`` indexes the valid slots of the
    flattened (batch * seq_len) rows."""
    rng = np.random.RandomState(seed)
    lens = rng.randint(seq_len // 2, seq_len + 1, batch).astype(np.int32)
    ids = rng.randint(0, vocab_size, (batch, seq_len)).astype(np.int32)
    labels = rng.randint(0, vocab_size, int(lens.sum())).astype(np.int32)
    pos = np.concatenate([r * seq_len + np.arange(n)
                          for r, n in enumerate(lens)])
    return lens, ids, labels, pos


def on_device(arrays, device, as_np=False):
    """:func:`synthetic_arrays`' batch as the step takes it:
    ``(ids, token_types, valid_length, positions, labels, n_valid)``,
    as tensors or (``as_np``) as ``mx.np`` arrays."""
    lens, ids, labels, pos = arrays
    make = (lambda a: mnp.array(a, ctx=device)) if as_np else \
        (lambda a: torch.tensor(a, device=device))
    return (make(ids), make(np.zeros(ids.shape, np.int32)), make(lens),
            make(pos), make(labels), int(lens.sum()))


def synthetic_batch(seed, batch, seq_len, vocab_size, device, as_np=False):
    return on_device(synthetic_arrays(seed, batch, seq_len, vocab_size),
                     device, as_np)


def train_step(net, head, trainer, batch, update=True):
    """One MLM step: the loss (shape (1,), summed over the valid
    positions) through ``amp.scale_loss``, backward, and (``update``)
    ``trainer.step``. Returns the loss."""
    ids, tt, lens, pos, labels, n_valid = batch
    with autograd.record():
        seq = net(ids, tt, lens)
        flat = seq.reshape(-1, seq.shape[-1])[pos]
        loss = nd.softmax_cross_entropy(head(flat), labels)
    with amp.scale_loss(loss, trainer) as scaled:
        autograd.backward(scaled)
    if update:
        trainer.step(n_valid)
    return loss


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--amp", default="bfloat16",
                    choices=("bfloat16", "float16", "none"))
    ap.add_argument("--layers", type=int, default=12)
    ap.add_argument("--batch-size", type=int, default=64)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--lr", type=float, default=1e-4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    ap.add_argument("--quick", action="store_true",
                    help="a tiny model: 2 layers of 64 units, vocab 1000")
    ap.add_argument("--np", action="store_true",
                    help="train under npx.set_np() on mx.np arrays")
    args = ap.parse_args(argv)
    widths = dict(vocab_size=1000, units=64, hidden_size=128, num_heads=4,
                  max_length=64) if args.quick else {}
    if args.quick:
        args.batch_size, args.seq_len, args.layers = 8, 32, 2
        args.lr = 1e-3
    dev = resolve_device(args.device)
    if args.amp != "none":
        amp.init(args.amp)
    if args.np:
        npx.set_np()
    try:
        net, head, _, trainer = build(dev, num_layers=args.layers,
                                   seed=args.seed, lr=args.lr, **widths)
        if args.amp != "none":
            amp.init_trainer(trainer)
        batch = synthetic_batch(args.seed + 4, args.batch_size,
                                args.seq_len,
                                widths.get("vocab_size", 30522), dev,
                                as_np=args.np)
        losses = []
        for step in range(args.steps):
            loss = train_step(net, head, trainer, batch)
            losses.append(loss.item() / batch[-1])
            print(f"step {step}: loss per token {losses[-1]:.6f}")
    finally:
        amp.disable()
        if args.np:
            npx.reset_np()
    return losses


if __name__ == "__main__":
    main()
