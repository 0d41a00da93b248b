"""Wide & Deep recommender (BASELINE config 5).

Port of ``mxnet_tpu/gluon/model_zoo/wide_deep.py``: the wide part is a
(wide_dim, num_classes) table whose rows at a sample's multi-hot ids
are summed (a linear model over the ids), the deep part the fields'
embeddings, concatenated with the continuous features, into an MLP.
Written, as the JAX model is, as a ``hybrid_forward`` over ``F``
(``mx.nd``): eager, or after ``hybridize()`` a CUDA graph forward and
backward. The tables are ``Embedding(sparse_grad=True)``: their
parameters record ``grad_stype="row_sparse"`` and take dense gradients,
as in the JAX package, whose sum over repeated ids has a fixed order
(``ndarray.op_impl_basic.segment_sum``).

``fused_fields=True`` (the default) keeps ONE table over all fields and
adds each field's static offset to its ids (one gather of B x F rows);
``fused_fields=False`` keeps a table per field. The two lay out their
parameters differently: a parameter file of one loads only into the
other's layout after its tables are split or joined.
"""
from __future__ import annotations

import numpy as np

from ..block import HybridBlock
from ..nn import Dense, Embedding, HybridSequential

__all__ = ["WideDeep", "wide_deep"]


class WideDeep(HybridBlock):
    """
    Parameters
    ----------
    wide_dim : size of the wide (multi-hot) feature space
    field_dims : vocab size per categorical field (deep part)
    embed_dim : embedding width per field
    hidden_units : MLP widths
    num_classes : output classes (2 for CTR)
    sparse_grad : the tables' ``grad_stype`` is ``"row_sparse"``
    fused_fields : one offset-indexed table instead of one per field
        (module docstring)
    device : the parameters' device (the current context's by default)
    """

    def __init__(self, wide_dim, field_dims, embed_dim=16,
                 hidden_units=(256, 128, 64), num_classes=2,
                 sparse_grad=True, fused_fields=True, prefix=None,
                 params=None, device=None):
        super().__init__(prefix=prefix, params=params)
        self._num_fields = len(field_dims)
        self._embed_dim = embed_dim
        self._fused = bool(fused_fields)
        with self.name_scope():
            self.wide = Embedding(wide_dim, num_classes,
                                  sparse_grad=sparse_grad, prefix="wide_",
                                  device=device)
            self.embeddings = []
            if self._fused:
                self._field_offsets = tuple(
                    int(v) for v in np.cumsum([0] + list(field_dims[:-1])))
                self.field_embed = Embedding(int(sum(field_dims)),
                                             embed_dim,
                                             sparse_grad=sparse_grad,
                                             prefix="fields_", device=device)
            else:
                for i, dim in enumerate(field_dims):
                    emb = Embedding(dim, embed_dim, sparse_grad=sparse_grad,
                                    prefix=f"embed{i}_", device=device)
                    self.embeddings.append(self.register_child(emb))
            self.deep = HybridSequential(prefix="deep_")
            with self.deep.name_scope():
                for h in hidden_units:
                    self.deep.add(Dense(h, activation="relu",
                                        device=device))
                self.deep.add(Dense(num_classes, device=device))

    def hybrid_forward(self, F, wide_x, cat_x, cont_x=None):
        """wide_x: (B, Nw) int multi-hot ids; cat_x: (B, F) one id per
        field; cont_x: optional (B, C) continuous features."""
        wide_out = F.sum(self.wide(wide_x), axis=1)      # (B, classes)
        if self._fused:
            offs = F._constant(value=(self._field_offsets,), dtype="int32",
                               ctx=cat_x.device)
            ids = (cat_x + offs).reshape((-1,))
            deep_in = self.field_embed(ids).reshape(
                (-1, self._num_fields * self._embed_dim))
        else:
            embs = [emb(F.slice_axis(cat_x, axis=1, begin=i, end=i + 1)
                        .reshape((-1,)))
                    for i, emb in enumerate(self.embeddings)]
            deep_in = F.concat(*embs, dim=-1)
        if cont_x is not None:
            deep_in = F.concat(deep_in, cont_x, dim=-1)
        return wide_out + self.deep(deep_in)


def wide_deep(wide_dim=100000, num_fields=26, field_dim=10000,
              embed_dim=16, **kwargs):
    return WideDeep(wide_dim, [field_dim] * num_fields,
                    embed_dim=embed_dim, **kwargs)
