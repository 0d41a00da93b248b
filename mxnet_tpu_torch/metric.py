"""Evaluation metrics (``mxnet_tpu/metric.py``'s counterpart).

The same API: ``EvalMetric`` with ``update``/``get``/``reset``,
``CompositeEvalMetric``, the ``create`` registry (names and aliases
such as ``"acc"``, ``"ce"``, ``"top_k_acc"``) and the metrics the
training examples read: Accuracy, TopKAccuracy, CrossEntropy and
Perplexity (the others wait: ROADMAP Queue 1, 'Vision remainders').
Labels and predictions are torch tensors (on any device) or arrays.
A metric is a sync point by nature: ``Accuracy`` reduces on the
tensors' device and reads back one count an update; the others take
the values to the host, as the JAX package does.
"""
from __future__ import annotations

import math

import numpy
import torch

from .base import MXNetError

__all__ = ["Accuracy", "CompositeEvalMetric", "CrossEntropy", "EvalMetric",
           "Perplexity", "TopKAccuracy", "create", "register"]

_REG = {}


def register(klass=None, name=None):
    """Register a metric class under ``name`` (its lower-cased class
    name by default); usable as a bare decorator."""
    if klass is None:
        return lambda k: register(k, name)
    _REG[(name or klass.__name__).lower()] = klass
    return klass


def create(metric, *args, **kwargs):
    """A metric from a name, a list of them (a composite) or an
    ``EvalMetric`` (passed through)."""
    if isinstance(metric, EvalMetric):
        return metric
    if isinstance(metric, list):
        composite = CompositeEvalMetric()
        for child in metric:
            composite.add(create(child, *args, **kwargs))
        return composite
    try:
        klass = _REG[metric.lower()]
    except KeyError:
        raise MXNetError(f"metric '{metric}' is not registered. Known: "
                         f"{sorted(_REG)}") from None
    return klass(*args, **kwargs)


def _as_np(x):
    if isinstance(x, torch.Tensor):
        x = x.detach()
        if x.is_floating_point() and x.dtype != torch.float64:
            x = x.float()
        return x.cpu().numpy()
    return numpy.asarray(x)


def check_label_shapes(labels, preds, wrap=False, shape=False):
    if isinstance(labels, torch.Tensor):
        labels = [labels]
    if isinstance(preds, torch.Tensor):
        preds = [preds]
    if len(labels) != len(preds):
        raise ValueError(f"Shape of labels {len(labels)} does not match "
                         f"shape of predictions {len(preds)}")
    return labels, preds


class EvalMetric:
    """Base: ``update(labels, preds)`` adds to a running sum and count,
    ``get()`` gives ``(name, sum / count)`` (NaN before any update)."""

    def __init__(self, name, output_names=None, label_names=None, **kwargs):
        self.name = str(name)
        self.output_names = output_names
        self.label_names = label_names
        self._kwargs = kwargs
        self.reset()

    def __str__(self):
        return f"EvalMetric: {dict(zip(*self.get()))}"

    def get_config(self):
        config = dict(self._kwargs)
        config.update({"metric": type(self).__name__, "name": self.name,
                       "output_names": self.output_names,
                       "label_names": self.label_names})
        return config

    def update_dict(self, label, pred):
        if self.output_names is not None:
            pred = [pred[name] for name in self.output_names if name in pred]
        else:
            pred = list(pred.values())
        if self.label_names is not None:
            label = [label[name] for name in self.label_names
                     if name in label]
        else:
            label = list(label.values())
        self.update(label, pred)

    def update(self, labels, preds):
        raise NotImplementedError

    def reset(self):
        self.num_inst = 0
        self.sum_metric = 0.0
        self.global_num_inst = 0
        self.global_sum_metric = 0.0

    def reset_local(self):
        self.num_inst = 0
        self.sum_metric = 0.0

    def get(self):
        if self.num_inst == 0:
            return (self.name, float("nan"))
        return (self.name, self.sum_metric / self.num_inst)

    def get_global(self):
        if self.global_num_inst == 0:
            return (self.name, float("nan"))
        return (self.name, self.global_sum_metric / self.global_num_inst)

    def get_name_value(self):
        name, value = self.get()
        if not isinstance(name, list):
            name = [name]
        if not isinstance(value, list):
            value = [value]
        return list(zip(name, value))

    def _inc(self, metric, inst):
        self.sum_metric += metric
        self.num_inst += inst
        self.global_sum_metric += metric
        self.global_num_inst += inst


class CompositeEvalMetric(EvalMetric):
    """Several metrics updated together; ``get`` gives lists."""

    def __init__(self, metrics=None, name="composite", output_names=None,
                 label_names=None):
        super().__init__(name, output_names, label_names)
        self.metrics = [create(m) for m in (metrics or [])]

    def add(self, metric):
        self.metrics.append(create(metric))

    def get_metric(self, index):
        return self.metrics[index]

    def update_dict(self, labels, preds):
        for metric in self.metrics:
            metric.update_dict(labels, preds)

    def update(self, labels, preds):
        for metric in self.metrics:
            metric.update(labels, preds)

    def reset(self):
        for metric in getattr(self, "metrics", []):
            metric.reset()

    def reset_local(self):
        for metric in getattr(self, "metrics", []):
            metric.reset_local()

    def get(self):
        names, values = [], []
        for metric in self.metrics:
            name, value = metric.get()
            if isinstance(name, str):
                name = [name]
            if isinstance(value, (float, int, numpy.generic)):
                value = [value]
            names.extend(name)
            values.extend(value)
        return (names, values)


@register(name="acc")
@register
class Accuracy(EvalMetric):
    """Share of argmax predictions (over ``axis``) equal to the label;
    a prediction of the label's rank is taken as class ids."""

    def __init__(self, axis=1, name="accuracy", output_names=None,
                 label_names=None):
        super().__init__(name, output_names, label_names, axis=axis)
        self.axis = axis

    def update(self, labels, preds):
        labels, preds = check_label_shapes(labels, preds, True)
        for label, pred in zip(labels, preds):
            pred = torch.as_tensor(pred)
            label = torch.as_tensor(label, device=pred.device)
            if pred.ndim > label.ndim:
                pred = pred.argmax(dim=self.axis)
            pred = pred.to(torch.int32).reshape(-1)
            label = label.to(torch.int32).reshape(-1)
            self._inc(int((pred == label).sum()), label.numel())


@register(name="top_k_accuracy")
@register(name="top_k_acc")
@register
class TopKAccuracy(EvalMetric):
    """Share of rows whose label is among the ``top_k`` largest
    predictions."""

    def __init__(self, top_k=1, name="top_k_accuracy", output_names=None,
                 label_names=None):
        super().__init__(name, output_names, label_names, top_k=top_k)
        self.top_k = top_k
        if self.top_k <= 1:
            raise ValueError("Please use Accuracy if top_k is no more "
                             "than 1")
        self.name += f"_{self.top_k}"

    def update(self, labels, preds):
        labels, preds = check_label_shapes(labels, preds, True)
        for label, pred in zip(labels, preds):
            pred, label = _as_np(pred), _as_np(label).astype(numpy.int32)
            if pred.ndim != 2:
                raise ValueError("TopKAccuracy takes (batch, classes) "
                                 "predictions")
            arg = numpy.argsort(pred, axis=1)[:, ::-1][:, :self.top_k]
            correct = int((arg == label.reshape(-1, 1)).any(axis=1).sum())
            self._inc(correct, len(label))


@register(name="ce")
@register
class CrossEntropy(EvalMetric):
    """Mean of ``-log(p[label] + eps)`` over rows of probabilities."""

    def __init__(self, eps=1e-12, name="cross-entropy", output_names=None,
                 label_names=None):
        super().__init__(name, output_names, label_names, eps=eps)
        self.eps = eps

    def update(self, labels, preds):
        labels, preds = check_label_shapes(labels, preds, True)
        for label, pred in zip(labels, preds):
            label = _as_np(label).ravel().astype(numpy.int64)
            pred = _as_np(pred)
            if label.shape[0] != pred.shape[0]:
                raise ValueError("CrossEntropy: labels and predictions "
                                 "have different row counts")
            prob = pred[numpy.arange(label.shape[0]), label]
            self._inc(float((-numpy.log(prob + self.eps)).sum()),
                      label.shape[0])


@register
class Perplexity(EvalMetric):
    """``exp`` of the mean ``-log p[label]`` (probabilities floored at
    1e-10), ``ignore_label`` rows left out."""

    def __init__(self, ignore_label=None, axis=-1, name="perplexity",
                 output_names=None, label_names=None):
        super().__init__(name, output_names, label_names,
                         ignore_label=ignore_label, axis=axis)
        self.ignore_label = ignore_label
        self.axis = axis

    def update(self, labels, preds):
        labels, preds = check_label_shapes(labels, preds, True)
        loss = 0.0
        num = 0
        for label, pred in zip(labels, preds):
            label = _as_np(label).reshape(-1).astype(numpy.int64)
            pred = _as_np(pred).reshape(label.shape[0], -1)
            probs = pred[numpy.arange(label.shape[0]), label]
            if self.ignore_label is not None:
                ignore = (label == self.ignore_label)
                probs = numpy.where(ignore, 1.0, probs)
                num -= int(ignore.sum())
            loss -= float(numpy.log(numpy.maximum(1e-10, probs)).sum())
            num += label.shape[0]
        self._inc(loss, num)

    def get(self):
        if self.num_inst == 0:
            return (self.name, float("nan"))
        return (self.name, math.exp(self.sum_metric / self.num_inst))
