"""Transformer layers: MultiHeadAttention, PositionwiseFFN, encoder.

Port of ``mxnet_tpu/gluon/nn/transformer.py``. Layout (batch, seq,
units); post-LN residual blocks (BERT) or pre-LN (``pre_norm=True``).

Attention without an additive mask takes the flash path: one call of
the fused kernel per layer (``ops.flash_attention``: the hand-written
CUDA kernel on the card), which masks per-row key lengths and packed
``segment_ids`` itself. With an additive mask (or attention dropout
while training) it composes scores + masks + softmax in plain torch,
as the JAX package composes batch_dot + softmax; the tests hold the
two paths against each other. Under ``contrib.amp`` the composed
softmax casts as the JAX ``softmax`` op (float32); the projections cast
in their ``Dense`` layers.

A Symbol goes through each block's ``hybrid_forward``, the JAX
package's F-op body (``export``): attention emits ``flash_attention``
on exactly the branches where the JAX block does. The children without
parameters (activations, dropouts) are made in their parent's name
scope, so their prefixes, and the graph's node names, are the JAX
blocks'.
"""
from __future__ import annotations

import math

import torch

from ... import autograd
from ...ndarray import op_impl_nn as _nn
from ...ndarray.register import amp_cast
from ..block import HybridBlock
from .basic_layers import Activation, Dense, Dropout, LayerNorm

__all__ = ["MultiHeadAttention", "PositionwiseFFN", "TransformerEncoder",
           "TransformerEncoderCell"]


class MultiHeadAttention(HybridBlock):
    """Self-attention with a fused QKV projection (units = num_heads *
    head_dim)."""

    def __init__(self, units, num_heads, attention_dropout=0.0,
                 use_bias=True, causal=False, dtype="float32", prefix="",
                 device=None):
        super().__init__(prefix)
        if units % num_heads:
            raise ValueError(f"units {units} not divisible by heads "
                             f"{num_heads}")
        self._units = units
        self._heads = num_heads
        self._causal = causal
        self._attn_drop = attention_dropout
        self.qkv_proj = Dense(3 * units, flatten=False, use_bias=use_bias,
                              dtype=dtype, in_units=units, prefix="qkv_",
                              device=device)
        self.out_proj = Dense(units, flatten=False, use_bias=use_bias,
                              dtype=dtype, in_units=units, prefix="out_",
                              device=device)
        with self.name_scope():
            self.dropout = (Dropout(attention_dropout) if attention_dropout
                            else None)

    def forward(self, x, mask=None, valid_length=None, segment_ids=None):
        b, s, c = x.shape
        qkv = self.qkv_proj(x).view(b, s, 3, self._heads, c // self._heads)
        # (B, H, S, D) views of the projection: the kernel takes strided
        # heads, so no copy is made
        q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))

        # packed rows: the flash path needs each row's used length too;
        # packers lay segments contiguously, so the nonzero count is it
        if segment_ids is not None and valid_length is None:
            valid_length = _nn.segment_valid_len(segment_ids)

        need_drop = bool(self._attn_drop) and autograd.is_training()
        if mask is None and not need_drop:
            out = _nn.flash_attention_op(q, k, v, valid_length, segment_ids,
                                         causal=self._causal)
        else:
            scale = 1.0 / math.sqrt(c // self._heads)
            scores = _nn.batch_dot_attention_scores(q, k) * scale
            if mask is not None:
                scores = scores + mask
            if valid_length is not None:
                scores = _nn.attention_length_mask(scores, valid_length)
            if segment_ids is not None:
                scores = _nn.attention_segment_mask(scores, segment_ids)
            if self._causal:
                scores = _nn.causal_mask_scores(scores)
            probs = torch.softmax(*amp_cast("softmax", scores), dim=-1)
            if valid_length is not None:
                probs = _nn.attention_zero_empty_rows(probs, valid_length)
            if segment_ids is not None:
                probs = _nn.attention_zero_pad_rows(probs, segment_ids)
            if self.dropout is not None:
                probs = self.dropout(probs)
            out = _nn.batch_dot_attention_apply(probs, v)
        # (B, H, S, D) -> (B, S, C); free when the kernel wrote o into
        # its (B, S, H, D) buffer
        out = out.transpose(1, 2).reshape(b, s, c)
        return self.out_proj(out)

    def _split_heads(self, F, x):
        # (B, S, C) -> (B, H, S, D)
        x = F.reshape(x, shape=(0, 0, self._heads, -1))
        return F.transpose(x, axes=(0, 2, 1, 3))

    def hybrid_forward(self, F, x, mask=None, valid_length=None,
                       segment_ids=None):
        c = self._units
        qkv = self.qkv_proj(x)
        q = self._split_heads(F, F.slice_axis(qkv, axis=-1, begin=0, end=c))
        k = self._split_heads(F, F.slice_axis(qkv, axis=-1, begin=c,
                                              end=2 * c))
        v = self._split_heads(F, F.slice_axis(qkv, axis=-1, begin=2 * c,
                                              end=3 * c))
        if segment_ids is not None and valid_length is None:
            valid_length = F.segment_valid_len(segment_ids)
        need_drop = bool(self._attn_drop) and autograd.is_training()
        if mask is None and not need_drop:
            if segment_ids is not None:
                out = F.flash_attention(q, k, v, valid_length, segment_ids,
                                        causal=self._causal)
            elif valid_length is not None:
                out = F.flash_attention(q, k, v, valid_length,
                                        causal=self._causal)
            else:
                out = F.flash_attention(q, k, v, causal=self._causal)
        else:
            scale = 1.0 / math.sqrt(c // self._heads)
            scores = F.batch_dot_attention_scores(q, k) * scale
            if mask is not None:
                scores = F.broadcast_add(scores, mask)
            if valid_length is not None:
                scores = F.attention_length_mask(scores, valid_length)
            if segment_ids is not None:
                scores = F.attention_segment_mask(scores, segment_ids)
            if self._causal:
                scores = F.causal_mask_scores(scores)
            probs = F.softmax(scores, axis=-1)
            if valid_length is not None:
                probs = F.attention_zero_empty_rows(probs, valid_length)
            if segment_ids is not None:
                probs = F.attention_zero_pad_rows(probs, segment_ids)
            if self.dropout is not None:
                probs = self.dropout(probs)
            out = F.batch_dot_attention_apply(probs, v)
        out = F.transpose(out, axes=(0, 2, 1, 3))    # (B, S, H, D)
        out = F.reshape(out, shape=(0, 0, -1))       # (B, S, C)
        return self.out_proj(out)


class PositionwiseFFN(HybridBlock):
    """Dense(hidden, act) -> Dense(units), with dropout."""

    def __init__(self, units, hidden_size, activation="gelu", dropout=0.0,
                 dtype="float32", prefix="", device=None):
        super().__init__(prefix)
        self.ffn_1 = Dense(hidden_size, flatten=False, dtype=dtype,
                           in_units=units, prefix="ffn1_", device=device)
        with self.name_scope():
            self.act = Activation(activation)
        self.ffn_2 = Dense(units, flatten=False, dtype=dtype,
                           in_units=hidden_size, prefix="ffn2_",
                           device=device)
        with self.name_scope():
            self.dropout = Dropout(dropout) if dropout else None

    def forward(self, x):
        out = self.ffn_2(self.act(self.ffn_1(x)))
        if self.dropout is not None:
            out = self.dropout(out)
        return out

    def hybrid_forward(self, F, x):
        return self.forward(x)


class TransformerEncoderCell(HybridBlock):
    """One encoder layer: MHA + residual + LN, FFN + residual + LN."""

    def __init__(self, units, hidden_size, num_heads, dropout=0.0,
                 attention_dropout=0.0, activation="gelu", pre_norm=False,
                 causal=False, layer_norm_eps=1e-12, dtype="float32",
                 prefix="", device=None):
        super().__init__(prefix)
        self._pre_norm = pre_norm
        self.attention = MultiHeadAttention(
            units, num_heads, attention_dropout=attention_dropout,
            causal=causal, dtype=dtype, prefix="attn_", device=device)
        self.attn_ln = LayerNorm(epsilon=layer_norm_eps, in_channels=units,
                                 dtype=dtype, prefix="attn_ln_",
                                 device=device)
        self.ffn = PositionwiseFFN(units, hidden_size,
                                   activation=activation, dropout=dropout,
                                   dtype=dtype, prefix="ffn_",
                                   device=device)
        self.ffn_ln = LayerNorm(epsilon=layer_norm_eps, in_channels=units,
                                dtype=dtype, prefix="ffn_ln_",
                                device=device)
        with self.name_scope():
            self.dropout = Dropout(dropout) if dropout else None

    def forward(self, x, mask=None, valid_length=None, segment_ids=None):
        if self._pre_norm:
            h = self.attention(self.attn_ln(x), mask, valid_length,
                               segment_ids)
            if self.dropout is not None:
                h = self.dropout(h)
            x = x + h
            return x + self.ffn(self.ffn_ln(x))
        h = self.attention(x, mask, valid_length, segment_ids)
        if self.dropout is not None:
            h = self.dropout(h)
        x = self.attn_ln(x + h)
        return self.ffn_ln(x + self.ffn(x))

    def hybrid_forward(self, F, x, mask=None, valid_length=None,
                       segment_ids=None):
        return self.forward(x, mask, valid_length, segment_ids)


class TransformerEncoder(HybridBlock):
    """Stack of encoder cells (+ a final LN when ``pre_norm``)."""

    def __init__(self, num_layers, units, hidden_size, num_heads,
                 dropout=0.0, attention_dropout=0.0, activation="gelu",
                 pre_norm=False, causal=False, layer_norm_eps=1e-12,
                 dtype="float32", prefix="", device=None):
        super().__init__(prefix)
        # the cells are children "0", "1", ... as the JAX encoder's, so
        # the structural names (``encoder.0.ffn.ffn_1.weight``) agree
        self._cells = [
            TransformerEncoderCell(
                units, hidden_size, num_heads, dropout=dropout,
                attention_dropout=attention_dropout, activation=activation,
                pre_norm=pre_norm, causal=causal,
                layer_norm_eps=layer_norm_eps, dtype=dtype,
                prefix=f"layer{i}_", device=device)
            for i in range(num_layers)]
        for i, cell in enumerate(self._cells):
            self.add_module(str(i), cell)
        self.final_ln = (LayerNorm(epsilon=layer_norm_eps, in_channels=units,
                                   dtype=dtype, prefix="final_ln_",
                                   device=device)
                         if pre_norm else None)

    def forward(self, x, mask=None, valid_length=None, segment_ids=None):
        for cell in self._cells:
            x = cell(x, mask, valid_length, segment_ids)
        if self.final_ln is not None:
            x = self.final_ln(x)
        return x

    def hybrid_forward(self, F, x, mask=None, valid_length=None,
                       segment_ids=None):
        return self.forward(x, mask, valid_length, segment_ids)
