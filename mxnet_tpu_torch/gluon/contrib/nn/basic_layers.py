"""Contrib layers: ``Concurrent``, ``HybridConcurrent``, ``Identity``,
``SparseEmbedding``, ``SyncBatchNorm`` and ``PixelShuffle2D``.

Port of ``mxnet_tpu/gluon/contrib/nn/basic_layers.py``. The hybrid
layers are the JAX layers' ``hybrid_forward`` bodies over ``F``: on
tensors they run over ``mx.nd``, and a Symbol goes through them as
through any layer (``export``). ``SyncBatchNorm`` on one card is
``BatchNorm``: its statistics are the whole batch's.
"""
from __future__ import annotations

from .... import ndarray
from ...block import HybridBlock
from ...nn import BatchNorm, Embedding, HybridSequential, Sequential

__all__ = ["Concurrent", "HybridConcurrent", "Identity", "PixelShuffle2D",
           "SparseEmbedding", "SyncBatchNorm"]


class Concurrent(Sequential):
    """Each child on the same input, the outputs concatenated along
    ``axis``."""

    def __init__(self, axis=-1, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self.axis = axis

    def forward(self, x):
        out = [block(x) for block in self._modules.values()]
        return ndarray.concat(*out, dim=self.axis)


class HybridConcurrent(HybridSequential):
    """``Concurrent`` that hybridizes into one graph (its tensor
    ``forward`` is its ``hybrid_forward`` over ``mx.nd``, not
    ``Sequential``'s chain)."""

    def __init__(self, axis=-1, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self.axis = axis

    def forward(self, x):
        return self.hybrid_forward(ndarray, x)

    def hybrid_forward(self, F, x):
        out = [block(x) for block in self._modules.values()]
        return F.concat(*out, dim=self.axis)


class Identity(HybridBlock):
    """A copy of the input."""

    def hybrid_forward(self, F, x):
        return F.copy(x)


class SparseEmbedding(Embedding):
    """``Embedding`` whose weight's gradient is declared ``row_sparse``
    (``sparse_grad=True``: dense in memory, as the JAX layer's)."""

    def __init__(self, input_dim, output_dim, dtype="float32",
                 weight_initializer=None, **kwargs):
        super().__init__(input_dim, output_dim, dtype=dtype,
                         weight_initializer=weight_initializer,
                         sparse_grad=True, **kwargs)


class SyncBatchNorm(BatchNorm):
    """Cross-device BatchNorm. One card holds one replica, whose batch
    statistics are the whole batch's: ``BatchNorm`` over the channel
    axis 1. ``num_devices`` past 1 raises ``ValueError``, as a context
    list does."""

    def __init__(self, in_channels=0, num_devices=None, momentum=0.9,
                 epsilon=1e-5, center=True, scale=True,
                 use_global_stats=False, beta_initializer="zeros",
                 gamma_initializer="ones", running_mean_initializer="zeros",
                 running_variance_initializer="ones", **kwargs):
        if num_devices is not None and int(num_devices) > 1:
            raise ValueError(f"SyncBatchNorm over {num_devices} devices: "
                             f"one card holds one replica")
        super().__init__(axis=1, momentum=momentum, epsilon=epsilon,
                         center=center, scale=scale,
                         use_global_stats=use_global_stats,
                         beta_initializer=beta_initializer,
                         gamma_initializer=gamma_initializer,
                         running_mean_initializer=running_mean_initializer,
                         running_variance_initializer=(
                             running_variance_initializer),
                         in_channels=in_channels, **kwargs)
        self._num_devices = num_devices


class PixelShuffle2D(HybridBlock):
    """(N, C * f1 * f2, H, W) -> (N, C, H * f1, W * f2)."""

    def __init__(self, factor, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        try:
            self._factors = (int(factor),) * 2
        except TypeError:
            self._factors = tuple(int(f) for f in factor)

    def hybrid_forward(self, F, x):
        f1, f2 = self._factors
        x = F.reshape(x, shape=(0, -4, -1, f1 * f2, 0, 0))
        x = F.reshape(x, shape=(0, 0, -4, f1, f2, 0, 0))
        x = F.transpose(x, axes=(0, 1, 4, 2, 5, 3))
        return F.reshape(x, shape=(0, 0, -3, -3))
