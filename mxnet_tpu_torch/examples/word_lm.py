#!/usr/bin/env python
"""LSTM word language model, the port's copy of ``example/word_lm.py``:
embed -> dropout -> stacked fused LSTM -> dropout -> decoder, truncated
BPTT over contiguous text, gradient clipping, perplexity.
``WordLM(mode="gru")`` puts a stacked fused GRU in the LSTM's place.

    python -m mxnet_tpu_torch.examples.word_lm            # on the card
    python -m mxnet_tpu_torch.examples.word_lm --device cpu --quick
    python -m mxnet_tpu_torch.examples.word_lm --amp bfloat16

The text is the example's synthetic Markov corpus (each token strongly
predicts the next, so perplexity can fall well below uniform); pass
``--data`` for a tokenized corpus (one token id per line). The LSTM
runs the hand-written K6a/K6b kernels on the card (``ops/csrc/lstm.cu``).
:func:`train_segments` is the training loop ``chip_smoke.py`` and the
tests drive. ``--amp`` trains in mixed precision (``contrib.amp``): the
embedding, the LSTM (K6a/K6b in the half type) and the decoder in
bfloat16 or float16, the loss in float32; the backward goes through
``amp.scale_loss`` and the clipping threshold scales with the loss.
:func:`train_segments` also takes the token ids as an ``mx.np`` array
under ``npx.set_np()``: every segment, output, loss and gradient is then
an ``mx.np.ndarray``, and the layers still see plain tensors and launch
the same kernels.
"""
from __future__ import annotations

import argparse
import math

import numpy as np
import torch

from .. import autograd, gluon
from ..context import resolve_device
from ..contrib import amp
from ..gluon import nn, rnn
from ..gluon.utils import clip_global_norm
from ..initializer import Xavier

__all__ = ["WordLM", "batchify", "synthetic_corpus", "train_segments"]


class WordLM(gluon.Block):
    """Embedding -> Dropout -> LSTM (NTC) -> Dropout -> Dense decoder
    (``mode="gru"``: a GRU in the LSTM's place). Children carry the JAX
    example's Gluon prefixes, so its weights load by name
    (``load_gluon_params``)."""

    def __init__(self, vocab, emb, hid, layers, dropout=0.2, prefix="",
                 device=None, mode="lstm"):
        super().__init__(prefix)
        dev = resolve_device(device)
        self.embed = nn.Embedding(vocab, emb, prefix="embedding0_",
                                  device=dev)
        self.drop = nn.Dropout(dropout, prefix="dropout0_")
        layer = {"lstm": rnn.LSTM, "gru": rnn.GRU}[mode]
        self.rnn = layer(hid, num_layers=layers, layout="NTC",
                         dropout=dropout, input_size=emb,
                         prefix=f"{mode}0_", device=dev)
        self.decoder = nn.Dense(vocab, flatten=False, in_units=hid,
                                prefix="dense0_", device=dev)

    def forward(self, x, states):
        """Stateful forward: the states thread across BPTT segments."""
        h = self.drop(self.embed(x))
        out, new_states = self.rnn(h, states)
        return self.decoder(self.drop(out)), new_states

    def begin_state(self, batch_size, device=None):
        """Zero states as plain tensors (the training loop passes
        tensors, so no NDArray wraps its steps)."""
        return self.rnn.begin_state(batch_size, func=torch.zeros,
                                    device=device)


def synthetic_corpus(n_tokens, vocab):
    """Markov chain: each token strongly predicts the next (the JAX
    example's corpus, bit for bit)."""
    rs = np.random.RandomState(0)
    nxt = rs.randint(0, vocab, vocab)
    toks = np.empty(n_tokens, np.int32)
    t = 0
    for i in range(n_tokens):
        toks[i] = t
        t = nxt[t] if rs.rand() < 0.8 else rs.randint(vocab)
    return toks


def batchify(tokens, batch_size):
    """(batch_size, n) rows of contiguous text."""
    n = len(tokens) // batch_size
    return tokens[:n * batch_size].reshape(batch_size, n)


def train_segments(net, trainer, data, bptt, clip, steps=None):
    """Truncated BPTT over ``data`` (batch, n) token ids, one segment
    of ``bptt`` tokens per step: detach the carried states, record the
    forward and ``SoftmaxCrossEntropyLoss``, ``autograd.backward``
    through ``amp.scale_loss`` (the loss itself without a loss scaler),
    ``clip_global_norm(grads, clip * bptt * batch * scale)`` (the
    gradients are scaled by the loss scale until the step divides it
    out) and ``trainer.step(bptt * batch)``. Yields each segment's
    per-row loss tensor (batch,), at most ``steps`` of them. ``data``
    given as a tensor (an ``mx.np`` array: np-mode) is sliced as it
    is."""
    device = next(net.parameters()).device
    if not isinstance(data, torch.Tensor):
        data = torch.as_tensor(np.asarray(data), device=device)
    data = data.long()
    batch = data.shape[0]
    loss_fn = gluon.loss.SoftmaxCrossEntropyLoss()
    params = [p for p in net.collect_params().values()
              if p.grad_req != "null"]
    scaler = getattr(trainer, "_amp_loss_scaler", None)
    states = net.begin_state(batch, device)
    starts = range(0, data.shape[1] - 1 - bptt, bptt)
    for seg, i in enumerate(starts):
        if steps is not None and seg >= steps:
            return
        xb, yb = data[:, i:i + bptt], data[:, i + 1:i + 1 + bptt]
        states = [s.detach() for s in states]   # truncate BPTT here
        with autograd.record():
            logits, states = net(xb, states)
            loss = loss_fn(logits, yb)
        scale = scaler.loss_scale if scaler is not None else 1.0
        with amp.scale_loss(loss, trainer) as scaled:
            autograd.backward(scaled)
        clip_global_norm([p.grad() for p in params],
                         clip * bptt * batch * scale)
        trainer.step(bptt * batch)
        yield loss


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--vocab", type=int, default=10000)
    ap.add_argument("--emsize", type=int, default=650)
    ap.add_argument("--nhid", type=int, default=650)
    ap.add_argument("--nlayers", type=int, default=2)
    ap.add_argument("--bptt", type=int, default=35)
    ap.add_argument("--batch-size", type=int, default=32)
    ap.add_argument("--lr", type=float, default=1.0)
    ap.add_argument("--optimizer", default="sgd")
    ap.add_argument("--clip", type=float, default=0.25)
    ap.add_argument("--dropout", type=float, default=0.2)
    ap.add_argument("--epochs", type=int, default=2)
    ap.add_argument("--tokens", type=int, default=200000)
    ap.add_argument("--data", default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--amp", default=None, choices=("bfloat16", "float16"),
                    help="train in mixed precision (contrib.amp)")
    args = ap.parse_args(argv)
    if args.quick:
        args.vocab, args.emsize, args.nhid = 200, 64, 64
        args.tokens, args.epochs, args.bptt = 20000, 4, 16
        args.dropout = 0.0
        args.optimizer, args.lr = "adam", 2e-3
    tokens = np.loadtxt(args.data, dtype=np.int32) if args.data else \
        synthetic_corpus(args.tokens, args.vocab)
    data = batchify(tokens, args.batch_size)
    if args.amp:
        amp.init(args.amp)
    try:
        net = WordLM(args.vocab, args.emsize, args.nhid, args.nlayers,
                     dropout=args.dropout, device=args.device)
        net.initialize(init=Xavier(), seed=args.seed)
        trainer = gluon.Trainer(net.collect_params(), args.optimizer,
                                {"learning_rate": args.lr})
        if args.amp:
            amp.init_trainer(trainer)
        for epoch in range(args.epochs):
            losses = [loss.float().mean().item() for loss in
                      train_segments(net, trainer, data, args.bptt,
                                     args.clip)]
            ppl = math.exp(sum(losses) / len(losses))
            print(f"epoch {epoch}: perplexity {ppl:.1f} (uniform would "
                  f"be {args.vocab})")
    finally:
        if args.amp:
            amp.disable()
    return ppl


if __name__ == "__main__":
    main()
