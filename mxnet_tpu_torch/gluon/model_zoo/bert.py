"""BERT trunk, its pretraining heads and its serving entry point.

Port of ``mxnet_tpu/gluon/model_zoo/bert.py`` (``BERTEmbeddings``,
``BERTModel``, ``BERTMLMHead``, ``BERTNSPHead``,
``get_bert``/``bert_base``/``bert_large`` and ``bert_serving_entry``).
``model(inputs, token_types, valid_length, mask, segment_ids,
positions)`` gives ``(sequence_output, pooled_output)``, or the
sequence output alone without a pooler. Packed rows (``io/packing``)
pass ``segment_ids`` and per-sequence ``positions``; attention then
stays inside each packed sequence (the flash kernel's segment path).

Weights are seeded (:meth:`~..block.Block.initialize`) or carried over
from the JAX blocks with each class's ``from_gluon_params``. Dropout
follows ``autograd.is_training()``: the identity outside
``autograd.record()``. ``device=None`` is the current CUDA device and
raises without one. Each block also has the JAX block's
``hybrid_forward``, which Symbols go through: ``model(mx.sym.var(
"data"), mx.sym.var("token_types"), mx.sym.var("valid_length"))``
builds the encoder's graph (one ``flash_attention`` node a layer, on
``valid_length``), named as the JAX model's when the prefixes agree
(``prefix=``).
"""
from __future__ import annotations

import re

import torch

from ...context import resolve_device
from ..block import HybridBlock
from ..nn import (Activation, Dense, Dropout, Embedding, LayerNorm,
                  TransformerEncoder)

__all__ = ["BERTEmbeddings", "BERTMLMHead", "BERTModel", "BERTNSPHead",
           "bert_base", "bert_large", "bert_serving_entry", "get_bert"]


def _strip_prefix(params, anchor):
    """``params`` of one JAX block (names with its prefix, such as
    ``bertmodel0_``) without that prefix; the prefix is what precedes
    the one name ending in ``anchor``. Raises ``KeyError`` on no or
    several such names and on names outside the prefix."""
    hits = [k for k in params if k.endswith(anchor)]
    if len(hits) != 1:
        raise KeyError(f"params hold no single '<prefix>{anchor}'")
    prefix = hits[0][:-len(anchor)]
    foreign = sorted(k for k in params if not k.startswith(prefix))
    if foreign:
        raise KeyError(f"parameters outside the model prefix "
                       f"{prefix!r}: {foreign}")
    return {k[len(prefix):]: v for k, v in params.items()}


class BERTEmbeddings(HybridBlock):
    """token + position + segment embeddings, LN, dropout."""

    def __init__(self, vocab_size, units, max_length, token_types=2,
                 dropout=0.1, layer_norm_eps=1e-12, dtype="float32",
                 prefix="", device=None):
        super().__init__(prefix)
        self._max_length = int(max_length)
        self.word_embed = Embedding(vocab_size, units, dtype=dtype,
                                    prefix="word_", device=device)
        self.token_type_embed = Embedding(token_types, units, dtype=dtype,
                                          prefix="type_", device=device)
        self.position_embed = Embedding(max_length, units, dtype=dtype,
                                        prefix="pos_", device=device)
        self.ln = LayerNorm(epsilon=layer_norm_eps, in_channels=units,
                            dtype=dtype, prefix="ln_", device=device)
        with self.name_scope():
            self.dropout = Dropout(dropout) if dropout else None

    def forward(self, inputs, token_types, positions=None):
        # the gather clips out-of-range ids, which would alias every
        # position past max_length silently: reject instead
        seq_len = inputs.shape[1]
        if positions is None and seq_len > self._max_length:
            raise ValueError(f"sequence length {seq_len} exceeds "
                             f"max_length {self._max_length} of the "
                             f"position table")
        x = self.word_embed(inputs) + self.token_type_embed(token_types)
        if positions is None:
            pos = torch.arange(seq_len, device=inputs.device)
            x = x + self.position_embed(pos)[None]
        else:
            # packers bound position ids by each SAMPLE's length, so a
            # packed row may be longer than the table; every id may not.
            # Checked on the host only: on the card the check would wait
            # for the device once per forward, and there (as in the JAX
            # model once hybridized) the gather clips instead
            pmax = int(positions.max()) \
                if positions.device.type == "cpu" and positions.numel() \
                else 0
            if pmax >= self._max_length:
                raise ValueError(
                    f"position id {pmax} exceeds the position table "
                    f"(max_length {self._max_length}); packed samples "
                    "must each be at most max_length tokens")
            x = x + self.position_embed(positions)
        x = self.ln(x)
        if self.dropout is not None:
            x = self.dropout(x)
        return x

    def hybrid_forward(self, F, inputs, token_types, positions=None):
        x = self.word_embed(inputs) + self.token_type_embed(token_types)
        if positions is None:
            pos = F.arange_like(inputs, axis=1)
            x = x + F.expand_dims(self.position_embed(pos), 0)
        else:
            x = x + self.position_embed(positions)
        x = self.ln(x)
        if self.dropout is not None:
            x = self.dropout(x)
        return x


class BERTModel(HybridBlock):
    """Trunk: embeddings -> TransformerEncoder -> (seq_out, pooled_out).

    ``seed`` draws the weights (see :meth:`~..block.Block.initialize`);
    :meth:`from_gluon_params` takes the JAX model's instead."""

    def __init__(self, vocab_size=30522, units=768, hidden_size=3072,
                 num_layers=12, num_heads=12, max_length=512,
                 token_types=2, dropout=0.1, attention_dropout=0.1,
                 layer_norm_eps=1e-12, use_pooler=True, dtype="float32",
                 device=None, seed=0, prefix=None):
        super().__init__(prefix)
        self.device = resolve_device(device)
        self.units = units
        self.vocab_size = vocab_size
        self.embeddings = BERTEmbeddings(
            vocab_size, units, max_length, token_types=token_types,
            dropout=dropout, layer_norm_eps=layer_norm_eps, dtype=dtype,
            prefix="embed_", device=self.device)
        self.encoder = TransformerEncoder(
            num_layers, units, hidden_size, num_heads, dropout=dropout,
            attention_dropout=attention_dropout, activation="gelu",
            pre_norm=False, layer_norm_eps=layer_norm_eps, dtype=dtype,
            prefix="enc_", device=self.device)
        self.pooler = (Dense(units, flatten=False, activation="tanh",
                             dtype=dtype, in_units=units, prefix="pooler_",
                             device=self.device)
                       if use_pooler else None)
        self.initialize(seed=seed)

    def forward(self, inputs, token_types, valid_length=None, mask=None,
                segment_ids=None, positions=None):
        """``valid_length`` (B,) per-example token counts, ``mask`` an
        additive (B, 1|H, S, S) mask (composed attention), and for
        packed rows ``segment_ids`` (B, S) and ``positions`` (B, S).
        With packing the pooled output is meaningless (row slot 0 is
        only the first packed sequence's [CLS])."""
        x = self.embeddings(inputs, token_types, positions)
        seq = self.encoder(x, mask, valid_length, segment_ids)
        if self.pooler is None:
            return seq
        return seq, self.pooler(seq[:, 0])

    def hybrid_forward(self, F, inputs, token_types, valid_length=None,
                       mask=None, segment_ids=None, positions=None):
        x = self.embeddings(inputs, token_types, positions)
        seq = self.encoder(x, mask, valid_length, segment_ids)
        if self.pooler is None:
            return seq
        pooled = self.pooler(F.slice_axis(seq, axis=1, begin=0, end=1)
                             .reshape((0, -1)))
        return seq, pooled

    @classmethod
    def from_gluon_params(cls, params, num_heads, device=None,
                          layer_norm_eps=1e-12, dtype="float32"):
        """The port's model with the JAX model's weights:
        ``params`` is ``{name: array}`` of ``net.collect_params()``
        (Gluon names, with the model prefix such as ``bertmodel0_``).
        The geometry is read off the shapes (``num_heads`` is not in
        them). Raises ``KeyError`` on a missing or extra name and
        ``ValueError`` on a misshapen one."""
        p = _strip_prefix(params, "embed_word_weight")
        missing = [k for k in ("embed_pos_weight", "embed_type_weight")
                   if k not in p]
        if missing:
            raise KeyError(f"parameter names differ: missing {missing}")

        def shape(name):
            return tuple(getattr(p.get(name), "shape", ()))

        vocab, units = shape("embed_word_weight")
        layers = sum(1 for k in p
                     if re.fullmatch(r"enc_layer\d+_attn_qkv_weight", k))
        hidden = shape("enc_layer0_ffn_ffn1_weight")
        net = cls(vocab_size=vocab, units=units,
                  hidden_size=hidden[0] if hidden else 4 * units,
                  num_layers=layers, num_heads=num_heads,
                  max_length=shape("embed_pos_weight")[0],
                  token_types=shape("embed_type_weight")[0],
                  dropout=0.0, attention_dropout=0.0,
                  layer_norm_eps=layer_norm_eps,
                  use_pooler="pooler_weight" in p, dtype=dtype,
                  device=device)
        return net.load_gluon_params(p)


class BERTMLMHead(HybridBlock):
    """Masked-LM head: transform (Dense + erf GELU + LayerNorm), then
    the decoder to vocabulary logits."""

    def __init__(self, vocab_size, units, layer_norm_eps=1e-12,
                 dtype="float32", prefix="", device=None, seed=0):
        super().__init__(prefix)
        self.device = resolve_device(device)
        self.transform = Dense(units, flatten=False, dtype=dtype,
                               in_units=units, prefix="transform_",
                               device=self.device)
        with self.name_scope():
            self.act = Activation("gelu")
        self.ln = LayerNorm(epsilon=layer_norm_eps, in_channels=units,
                            dtype=dtype, prefix="ln_", device=self.device)
        self.decoder = Dense(vocab_size, flatten=False, dtype=dtype,
                             in_units=units, prefix="decoder_",
                             device=self.device)
        self.initialize(seed=seed)

    def forward(self, seq):
        return self.decoder(self.ln(self.act(self.transform(seq))))

    def hybrid_forward(self, F, seq):
        return self.forward(seq)

    @classmethod
    def from_gluon_params(cls, params, device=None, layer_norm_eps=1e-12,
                          dtype="float32"):
        """The port's head with the JAX head's weights (``params``:
        ``{name: array}`` of its ``collect_params()``, prefix such as
        ``bertmlmhead0_`` included)."""
        p = _strip_prefix(params, "decoder_weight")
        vocab, units = tuple(getattr(p["decoder_weight"], "shape", ()))
        head = cls(vocab, units, layer_norm_eps=layer_norm_eps,
                   dtype=dtype, device=device)
        return head.load_gluon_params(p)


class BERTNSPHead(HybridBlock):
    """Next-sentence head: Dense(2) over the pooled output."""

    def __init__(self, units=768, dtype="float32", prefix="", device=None,
                 seed=0):
        super().__init__(prefix)
        self.device = resolve_device(device)
        self.classifier = Dense(2, flatten=False, dtype=dtype,
                                in_units=units, prefix="cls_",
                                device=self.device)
        self.initialize(seed=seed)

    def forward(self, pooled):
        return self.classifier(pooled)

    def hybrid_forward(self, F, pooled):
        return self.forward(pooled)

    @classmethod
    def from_gluon_params(cls, params, device=None, dtype="float32"):
        """The port's head with the JAX head's weights (prefix such as
        ``bertnsphead0_`` included)."""
        p = _strip_prefix(params, "cls_weight")
        units = tuple(getattr(p["cls_weight"], "shape", ()))[1]
        return cls(units, dtype=dtype, device=device).load_gluon_params(p)


_BERT_SPECS = {
    "bert_base": dict(units=768, hidden_size=3072, num_layers=12,
                      num_heads=12),
    "bert_large": dict(units=1024, hidden_size=4096, num_layers=24,
                       num_heads=16),
}


def get_bert(spec="bert_base", vocab_size=30522, max_length=512,
             dropout=0.1, dtype="float32", **kwargs):
    cfg = dict(_BERT_SPECS[spec])
    cfg.update(kwargs)
    return BERTModel(vocab_size=vocab_size, max_length=max_length,
                     dropout=dropout, attention_dropout=dropout,
                     dtype=dtype, **cfg)


def bert_base(**kwargs):
    """BERT-base (L=12, H=768, A=12)."""
    return get_bert("bert_base", **kwargs)


def bert_large(**kwargs):
    """BERT-large (L=24, H=1024, A=16)."""
    return get_bert("bert_large", **kwargs)


def bert_serving_entry(model, head=None, hybridize=True):
    """Adapt a BERT trunk to the ``ServingEngine`` model contract:
    ``entry(ids, token_types, valid_length, segment_ids, positions) ->
    (B, S, U)`` per-token outputs on packed rows. Only the sequence
    output rides (the packed pooled output is meaningless); ``head``,
    if given, applies to it. ``hybridize`` hybridizes the trunk (and
    the head): each (rows, row_len) shape bucket then captures one CUDA
    graph at its first forward and replays it after, the serving fast
    path."""
    if hybridize:
        model.hybridize()
        if head is not None:
            head.hybridize()

    def entry(ids, token_types, valid_length, segment_ids, positions):
        out = model(ids, token_types, valid_length, None, segment_ids,
                    positions)
        seq = out[0] if isinstance(out, (list, tuple)) else out
        return head(seq) if head is not None else seq

    return entry
