"""BERT trunk and masked-LM head written as MXNet users write models:
``HybridBlock``s that declare their weights with ``self.params.get``
and compute in ``hybrid_forward(F, ...)`` with registry ops only
(``F.Embedding``, ``F.FullyConnected(flatten=False)``, ``F.LayerNorm``,
``F.slice_axis``, ``F.reshape`` with MXNet's codes 0 and -4,
``F.transpose``, ``F.flash_attention``, ``F.LeakyReLU``/``F.Activation``
with ``act_type="gelu"``, ``F.take`` and ``F.softmax_cross_entropy``),
after the reference model zoo's BERT (``gluon/model_zoo/bert.py``,
``gluon/nn/transformer.py``).

The file imports neither package: :func:`build` takes the ``gluon``
module, so one definition runs on the PyTorch port (``F`` its
``mx.nd``: flash attention, LayerNorm and the softmax cross-entropy
reach the hand-written CUDA kernels on the card) and on the JAX
package::

    from mxnet_tpu_torch import gluon, autograd
    net = build(gluon)                         # BERT-base widths
    net.initialize()
    with autograd.record():
        loss = net(ids, token_types, valid_length, positions, labels)
    loss.backward()

``net(...)`` gives the summed MLM loss over the predicted slots:
``positions`` are flat indices into the ``B * S`` slots, ``labels``
their targets. The parameter names are the port's model-zoo names
(``embed_word_weight``, ``enc_layer0_attn_qkv_weight``, ...; the
head's with ``mlm_`` before ``BERTMLMHead``'s), so :func:`zoo_name`
maps each to its counterpart and :func:`load_weights` takes a model
zoo trunk's and head's weights (either package's, or arrays by name).
"""
from __future__ import annotations

__all__ = ["build", "load_weights", "zoo_name"]

HEAD_PREFIX = "mlm_"


def zoo_name(name):
    """``(part, name)`` of a parameter of :func:`build`'s model in the
    model zoo's pair: ``("trunk", ...)`` for ``BERTModel``,
    ``("head", ...)`` for ``BERTMLMHead``."""
    if name.startswith(HEAD_PREFIX):
        return "head", name[len(HEAD_PREFIX):]
    return "trunk", name


def _local(model, name):
    pre = model.prefix
    return name[len(pre):] if pre and name.startswith(pre) else name


def load_weights(model, trunk, head):
    """Copy a model zoo trunk's and head's weights into ``model``.
    ``trunk``/``head`` are blocks of either package or ``{name:
    array}`` dicts without the model prefix. Raises ``KeyError`` when a
    name has no counterpart."""
    def named(src):
        if hasattr(src, "collect_params"):
            return {_local(src, k): v.data()
                    for k, v in src.collect_params().items()}
        return dict(src)

    parts = {"trunk": named(trunk), "head": named(head)}
    for name, param in model.collect_params().items():
        part, zname = zoo_name(_local(model, name))
        param.set_data(parts[part][zname])
    return model


def build(gluon, vocab_size=30522, units=768, num_layers=12, num_heads=12,
          hidden_size=3072, max_length=512, layer_norm_eps=1e-12):
    """The MLM model on ``gluon`` (the port's or the JAX package's), in
    float32, without dropout (the port's training cells run BERT at
    dropout 0)."""
    HybridBlock = gluon.HybridBlock

    class Embeddings(HybridBlock):
        """Word + token-type + position embeddings, then LayerNorm."""

        def __init__(self, **kwargs):
            super().__init__(**kwargs)
            with self.name_scope():
                self.word_weight = self.params.get(
                    "word_weight", shape=(vocab_size, units))
                self.type_weight = self.params.get(
                    "type_weight", shape=(2, units))
                self.pos_weight = self.params.get(
                    "pos_weight", shape=(max_length, units))
                self.ln_gamma = self.params.get(
                    "ln_gamma", shape=(units,), init="ones")
                self.ln_beta = self.params.get(
                    "ln_beta", shape=(units,), init="zeros")

        def hybrid_forward(self, F, ids, token_types, word_weight,
                           type_weight, pos_weight, ln_gamma, ln_beta):
            x = F.Embedding(ids, word_weight, input_dim=vocab_size,
                            output_dim=units) \
                + F.Embedding(token_types, type_weight, input_dim=2,
                              output_dim=units)
            pos = F.slice_axis(pos_weight, axis=0, begin=0,
                               end=ids.shape[1])
            x = F.broadcast_add(x, F.expand_dims(pos, axis=0))
            return F.LayerNorm(x, ln_gamma, ln_beta, axis=-1,
                               eps=layer_norm_eps)

    class EncoderLayer(HybridBlock):
        """Self-attention (fused QKV, flash attention over the valid
        lengths) + residual + LayerNorm, GELU FFN + residual +
        LayerNorm (post-LN, as BERT)."""

        def __init__(self, **kwargs):
            super().__init__(**kwargs)
            shapes = {
                "attn_qkv_weight": (3 * units, units),
                "attn_qkv_bias": (3 * units,),
                "attn_out_weight": (units, units),
                "attn_out_bias": (units,),
                "attn_ln_gamma": (units,), "attn_ln_beta": (units,),
                "ffn_ffn1_weight": (hidden_size, units),
                "ffn_ffn1_bias": (hidden_size,),
                "ffn_ffn2_weight": (units, hidden_size),
                "ffn_ffn2_bias": (units,),
                "ffn_ln_gamma": (units,), "ffn_ln_beta": (units,)}
            with self.name_scope():
                for name, shape in shapes.items():
                    init = "ones" if name.endswith("gamma") else \
                        "zeros" if name.endswith(("bias", "beta")) else None
                    setattr(self, name, self.params.get(
                        name, shape=shape, init=init))

        def _heads(self, F, t):
            # (B, S, U) -> (B, H, S, D)
            return F.transpose(F.reshape(t, shape=(0, 0, -4, num_heads, -1)),
                               axes=(0, 2, 1, 3))

        def hybrid_forward(self, F, x, valid_length, attn_qkv_weight,
                           attn_qkv_bias, attn_out_weight, attn_out_bias,
                           attn_ln_gamma, attn_ln_beta, ffn_ffn1_weight,
                           ffn_ffn1_bias, ffn_ffn2_weight, ffn_ffn2_bias,
                           ffn_ln_gamma, ffn_ln_beta):
            qkv = F.FullyConnected(x, attn_qkv_weight, attn_qkv_bias,
                                   num_hidden=3 * units, flatten=False)
            q, k, v = (self._heads(F, F.slice_axis(
                qkv, axis=-1, begin=i * units, end=(i + 1) * units))
                for i in range(3))
            att = F.flash_attention(q, k, v, valid_length)
            att = F.reshape(F.transpose(att, axes=(0, 2, 1, 3)),
                            shape=(0, 0, -1))
            h = F.FullyConnected(att, attn_out_weight, attn_out_bias,
                                 num_hidden=units, flatten=False)
            x = F.LayerNorm(x + h, attn_ln_gamma, attn_ln_beta, axis=-1,
                            eps=layer_norm_eps)
            f = F.FullyConnected(x, ffn_ffn1_weight, ffn_ffn1_bias,
                                 num_hidden=hidden_size, flatten=False)
            f = F.LeakyReLU(f, act_type="gelu")
            f = F.FullyConnected(f, ffn_ffn2_weight, ffn_ffn2_bias,
                                 num_hidden=units, flatten=False)
            return F.LayerNorm(x + f, ffn_ln_gamma, ffn_ln_beta, axis=-1,
                               eps=layer_norm_eps)

    class MLMHead(HybridBlock):
        """Dense + GELU + LayerNorm, then the vocabulary decoder."""

        def __init__(self, **kwargs):
            super().__init__(**kwargs)
            with self.name_scope():
                self.transform_weight = self.params.get(
                    "transform_weight", shape=(units, units))
                self.transform_bias = self.params.get(
                    "transform_bias", shape=(units,),
                    init="zeros")
                self.ln_gamma = self.params.get(
                    "ln_gamma", shape=(units,), init="ones")
                self.ln_beta = self.params.get(
                    "ln_beta", shape=(units,), init="zeros")
                self.decoder_weight = self.params.get(
                    "decoder_weight", shape=(vocab_size, units))
                self.decoder_bias = self.params.get(
                    "decoder_bias", shape=(vocab_size,),
                    init="zeros")

        def hybrid_forward(self, F, x, transform_weight, transform_bias,
                           ln_gamma, ln_beta, decoder_weight, decoder_bias):
            x = F.FullyConnected(x, transform_weight, transform_bias,
                                 num_hidden=units, flatten=False)
            x = F.Activation(x, act_type="gelu")
            x = F.LayerNorm(x, ln_gamma, ln_beta, axis=-1,
                            eps=layer_norm_eps)
            return F.FullyConnected(x, decoder_weight, decoder_bias,
                                    num_hidden=vocab_size, flatten=False)

    class BERTMLM(HybridBlock):
        """Embeddings -> encoder layers -> MLM head on the predicted
        slots -> summed softmax cross-entropy."""

        def __init__(self, **kwargs):
            super().__init__(**kwargs)
            with self.name_scope():
                self.embed = Embeddings(prefix="embed_")
                self.layers = []
                for i in range(num_layers):
                    cell = EncoderLayer(prefix=f"enc_layer{i}_")
                    setattr(self, f"layer{i}", cell)
                    self.layers.append(cell)
                self.mlm = MLMHead(prefix=HEAD_PREFIX)

        def hybrid_forward(self, F, ids, token_types, valid_length,
                           positions, labels):
            x = self.embed(ids, token_types)
            for cell in self.layers:
                x = cell(x, valid_length)
            flat = F.take(F.reshape(x, shape=(-1, units)), positions)
            return F.softmax_cross_entropy(self.mlm(flat), labels)

    return BERTMLM(prefix="hybridbert_")
