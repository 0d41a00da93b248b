"""Loss layers: ``Loss``, ``SoftmaxCrossEntropyLoss``, ``L2Loss``.

Port of those classes of ``mxnet_tpu/gluon/loss.py``. A loss is a
:class:`~.block.Block` returning one value per sample: the mean over
every axis but ``batch_axis``. ``SoftmaxCrossEntropyLoss`` is
``log_softmax`` + ``pick`` in plain torch, as in the JAX package (no
kernel there either); the fused kernel path is the
``ndarray.softmax_cross_entropy`` op.
"""
from __future__ import annotations

from ..ndarray import op_impl_nn as _nn
from .block import Block

__all__ = ["L2Loss", "Loss", "SoftmaxCELoss", "SoftmaxCrossEntropyLoss"]


def _apply_weighting(loss, weight=None, sample_weight=None):
    if sample_weight is not None:
        loss = loss * sample_weight
    if weight is not None:
        loss = loss * weight
    return loss


def _batch_mean(loss, batch_axis):
    axes = tuple(i for i in range(loss.ndim) if i != batch_axis % loss.ndim)
    return loss.mean(dim=axes) if axes else loss


class Loss(Block):
    """Base of the losses: ``weight`` scales, ``batch_axis`` is kept."""

    def __init__(self, weight, batch_axis, prefix=""):
        super().__init__(prefix)
        self._weight = weight
        self._batch_axis = batch_axis


class L2Loss(Loss):
    """``weight / 2 * (label - pred)**2``, averaged per sample."""

    def __init__(self, weight=1.0, batch_axis=0, prefix=""):
        super().__init__(weight, batch_axis, prefix)

    def forward(self, pred, label, sample_weight=None):
        loss = (label.reshape(pred.shape) - pred) ** 2
        loss = _apply_weighting(loss, self._weight / 2, sample_weight)
        return _batch_mean(loss, self._batch_axis)


class SoftmaxCrossEntropyLoss(Loss):
    """``-log softmax(pred)[label]`` (sparse labels) or ``-sum(log
    softmax(pred) * label)`` (dense), averaged per sample."""

    def __init__(self, axis=-1, sparse_label=True, from_logits=False,
                 weight=None, batch_axis=0, prefix=""):
        super().__init__(weight, batch_axis, prefix)
        self._axis = axis
        self._sparse_label = sparse_label
        self._from_logits = from_logits

    def forward(self, pred, label, sample_weight=None):
        if not self._from_logits:
            pred = _nn.log_softmax(pred, axis=self._axis)
        if self._sparse_label:
            loss = -_nn.pick(pred, label, axis=self._axis, keepdims=True)
        else:
            loss = -(pred * label.reshape(pred.shape)).sum(
                dim=self._axis, keepdim=True)
        loss = _apply_weighting(loss, self._weight, sample_weight)
        return _batch_mean(loss, self._batch_axis)


SoftmaxCELoss = SoftmaxCrossEntropyLoss
