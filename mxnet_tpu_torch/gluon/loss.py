"""Loss layers: ``Loss``, ``L2Loss``, ``L1Loss``, ``CTCLoss``,
``SoftmaxCrossEntropyLoss``, ``SigmoidBinaryCrossEntropyLoss``,
``KLDivLoss``, ``HuberLoss``, ``HingeLoss``, ``SquaredHingeLoss``,
``LogisticLoss``, ``TripletLoss`` and ``CosineEmbeddingLoss``.

Port of those classes of ``mxnet_tpu/gluon/loss.py``. A loss is a
:class:`~.block.Block` returning one value per sample: the mean over
every axis but ``batch_axis``. ``SoftmaxCrossEntropyLoss`` is
``log_softmax`` + ``pick`` in plain torch, as in the JAX package (no
kernel there either); the fused kernel path is the
``ndarray.softmax_cross_entropy`` op. The losses after it are the JAX
classes' ``hybrid_forward`` bodies over ``F`` (``mx.nd``), as written
there (the JAX package has no kernel in them). ``CTCLoss`` runs the
registered ``ctc_loss`` op (``ops/ctc.py``: the log-domain recursion
over time, blank 0). Under ``contrib.amp`` the torch bodies cast as
the JAX ops they stand for (``log_softmax``, ``sum`` and the final
``mean`` in float32; ``register.amp_cast``).
"""
from __future__ import annotations

from ..ndarray import op_impl_nn as _nn
from ..ndarray.register import amp_cast
from .block import HybridBlock

__all__ = ["CTCLoss", "CosineEmbeddingLoss", "HingeLoss", "HuberLoss",
           "KLDivLoss", "L1Loss", "L2Loss", "LogisticLoss", "Loss",
           "SigmoidBCELoss", "SigmoidBinaryCrossEntropyLoss", "SoftmaxCELoss",
           "SoftmaxCrossEntropyLoss", "SquaredHingeLoss", "TripletLoss"]


def _apply_weighting(loss, weight=None, sample_weight=None):
    if sample_weight is not None:
        loss = loss * sample_weight
    if weight is not None:
        loss = loss * weight
    return loss


def _batch_mean(loss, batch_axis):
    loss, = amp_cast("mean", loss)
    axes = tuple(i for i in range(loss.ndim) if i != batch_axis % loss.ndim)
    return loss.mean(dim=axes) if axes else loss


class Loss(HybridBlock):
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
            pred = _nn.log_softmax(*amp_cast("log_softmax", pred),
                                   axis=self._axis)
        if self._sparse_label:
            loss = -_nn.pick(pred, label, axis=self._axis, keepdims=True)
        else:
            prod, = amp_cast("sum", pred * label.reshape(pred.shape))
            loss = -prod.sum(dim=self._axis, keepdim=True)
        loss = _apply_weighting(loss, self._weight, sample_weight)
        return _batch_mean(loss, self._batch_axis)


SoftmaxCELoss = SoftmaxCrossEntropyLoss


class L1Loss(Loss):
    """``weight * |label - pred|``, averaged per sample."""

    def __init__(self, weight=None, batch_axis=0, prefix=""):
        super().__init__(weight, batch_axis, prefix)

    def hybrid_forward(self, F, pred, label, sample_weight=None):
        label = label.reshape(pred.shape)
        loss = F.abs(label - pred)
        loss = _apply_weighting(loss, self._weight, sample_weight)
        return _batch_mean(loss, self._batch_axis)


class SigmoidBinaryCrossEntropyLoss(Loss):
    """Binary cross-entropy of ``sigmoid(pred)`` (or of ``pred`` with
    ``from_sigmoid``) against a 0/1 ``label``, in the stable
    ``relu(x) - x * z + softrelu(-|x|)`` form; ``pos_weight`` scales
    the positive term."""

    def __init__(self, from_sigmoid=False, weight=None, batch_axis=0,
                 prefix=""):
        super().__init__(weight, batch_axis, prefix)
        self._from_sigmoid = from_sigmoid

    def hybrid_forward(self, F, pred, label, sample_weight=None,
                       pos_weight=None):
        label = label.reshape(pred.shape)
        if not self._from_sigmoid:
            if pos_weight is None:
                loss = F.relu(pred) - pred * label + \
                    F.Activation(-F.abs(pred), act_type="softrelu")
            else:
                log_weight = 1 + F.broadcast_mul(pos_weight - 1, label)
                loss = pred - pred * label + log_weight * \
                    (F.Activation(-F.abs(pred), act_type="softrelu")
                     + F.relu(-pred))
        else:
            eps = 1e-12
            if pos_weight is None:
                loss = -(F.log(pred + eps) * label
                         + F.log(1. - pred + eps) * (1. - label))
            else:
                loss = -(F.broadcast_mul(F.log(pred + eps) * label,
                                         pos_weight)
                         + F.log(1. - pred + eps) * (1. - label))
        loss = _apply_weighting(loss, self._weight, sample_weight)
        return _batch_mean(loss, self._batch_axis)


SigmoidBCELoss = SigmoidBinaryCrossEntropyLoss


class KLDivLoss(Loss):
    """``label * (log(label) - pred)`` (``pred`` log-probabilities, or
    logits without ``from_logits``)."""

    def __init__(self, from_logits=True, axis=-1, weight=None, batch_axis=0,
                 prefix=""):
        super().__init__(weight, batch_axis, prefix)
        self._from_logits = from_logits
        self._axis = axis

    def hybrid_forward(self, F, pred, label, sample_weight=None):
        if not self._from_logits:
            pred = F.log_softmax(pred, axis=self._axis)
        loss = label * (F.log(label + 1e-12) - pred)
        loss = _apply_weighting(loss, self._weight, sample_weight)
        return _batch_mean(loss, self._batch_axis)


class HuberLoss(Loss):
    """Squared error below ``rho``, absolute error above it."""

    def __init__(self, rho=1, weight=None, batch_axis=0, prefix=""):
        super().__init__(weight, batch_axis, prefix)
        self._rho = rho

    def hybrid_forward(self, F, pred, label, sample_weight=None):
        label = label.reshape(pred.shape)
        loss = F.abs(label - pred)
        loss = F.where(loss > self._rho,
                       loss - 0.5 * self._rho,
                       (0.5 / self._rho) * F.square(loss))
        loss = _apply_weighting(loss, self._weight, sample_weight)
        return _batch_mean(loss, self._batch_axis)


class HingeLoss(Loss):
    """``relu(margin - pred * label)`` for labels in {-1, 1}."""

    def __init__(self, margin=1, weight=None, batch_axis=0, prefix=""):
        super().__init__(weight, batch_axis, prefix)
        self._margin = margin

    def hybrid_forward(self, F, pred, label, sample_weight=None):
        label = label.reshape(pred.shape)
        loss = F.relu(self._margin - pred * label)
        loss = _apply_weighting(loss, self._weight, sample_weight)
        return _batch_mean(loss, self._batch_axis)


class SquaredHingeLoss(Loss):
    """``relu(margin - pred * label) ** 2``."""

    def __init__(self, margin=1, weight=None, batch_axis=0, prefix=""):
        super().__init__(weight, batch_axis, prefix)
        self._margin = margin

    def hybrid_forward(self, F, pred, label, sample_weight=None):
        label = label.reshape(pred.shape)
        loss = F.square(F.relu(self._margin - pred * label))
        loss = _apply_weighting(loss, self._weight, sample_weight)
        return _batch_mean(loss, self._batch_axis)


class LogisticLoss(Loss):
    """The logistic loss of ``pred`` for ``signed`` ({-1, 1}) or
    ``binary`` ({0, 1}) labels."""

    def __init__(self, weight=None, batch_axis=0, label_format="signed",
                 prefix=""):
        super().__init__(weight, batch_axis, prefix)
        self._label_format = label_format
        if self._label_format not in ["signed", "binary"]:
            raise ValueError(f"label_format can only be signed or binary, "
                             f"recieved {label_format}")

    def hybrid_forward(self, F, pred, label, sample_weight=None):
        label = label.reshape(pred.shape)
        if self._label_format == "signed":
            label = (label + 1.0) / 2.0
        loss = F.relu(pred) - pred * label + \
            F.Activation(-F.abs(pred), act_type="softrelu")
        loss = _apply_weighting(loss, self._weight, sample_weight)
        return _batch_mean(loss, self._batch_axis)


class TripletLoss(Loss):
    """``relu(|pred - positive|^2 - |pred - negative|^2 + margin)`` a
    sample."""

    def __init__(self, margin=1, weight=None, batch_axis=0, prefix=""):
        super().__init__(weight, batch_axis, prefix)
        self._margin = margin

    def hybrid_forward(self, F, pred, positive, negative,
                       sample_weight=None):
        positive = positive.reshape(pred.shape)
        negative = negative.reshape(pred.shape)
        ax = tuple(range(1, pred.ndim))
        loss = F.sum(F.square(pred - positive) - F.square(pred - negative),
                     axis=ax)
        loss = F.relu(loss + self._margin)
        return _apply_weighting(loss, self._weight, sample_weight)


class CosineEmbeddingLoss(Loss):
    """``1 - cos`` for label 1, ``relu(cos - margin)`` otherwise."""

    def __init__(self, weight=None, batch_axis=0, margin=0, prefix=""):
        super().__init__(weight, batch_axis, prefix)
        self._margin = margin

    def hybrid_forward(self, F, input1, input2, label, sample_weight=None):
        input1 = input1.reshape((input1.shape[0], -1))
        input2 = input2.reshape((input2.shape[0], -1))
        cos = F.sum(input1 * input2, axis=1) / (
            F.norm(input1, axis=1) * F.norm(input2, axis=1) + 1e-12)
        label = label.reshape((-1,))
        loss = F.where(label == 1, 1.0 - cos, F.relu(cos - self._margin))
        return _apply_weighting(loss, self._weight, sample_weight)


class CTCLoss(Loss):
    """Connectionist temporal classification: ``pred`` in ``layout``
    (``"NTC"`` or ``"TNC"``), ``label`` in ``label_layout`` (``"NT"`` or
    ``"TN"``), 0 the blank and the padding; optional ``pred_lengths``
    and ``label_lengths`` (else every frame, and the labels above 0)."""

    def __init__(self, layout="NTC", label_layout="NT", weight=None,
                 prefix=""):
        batch_axis = label_layout.find("N")
        super().__init__(weight, batch_axis, prefix)
        if layout not in ("NTC", "TNC"):
            raise ValueError(f"layout must be NTC or TNC, got {layout}")
        if label_layout not in ("NT", "TN"):
            raise ValueError(f"label_layout must be NT or TN, got "
                             f"{label_layout}")
        self._layout = layout
        self._label_layout = label_layout

    def hybrid_forward(self, F, pred, label, pred_lengths=None,
                       label_lengths=None, sample_weight=None):
        from ..ops.ctc import ctc_loss_nd

        if self._layout == "NTC":
            pred = pred.swapaxes(0, 1)
        if self._label_layout == "TN":
            label = label.swapaxes(0, 1)
        loss = ctc_loss_nd(pred, label, pred_lengths, label_lengths)
        return _apply_weighting(loss, self._weight, sample_weight)
