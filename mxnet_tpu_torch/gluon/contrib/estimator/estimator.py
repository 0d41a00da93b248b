"""Estimator: MXNet 1.6's high-level ``fit`` over Gluon blocks.

Port of ``mxnet_tpu/gluon/contrib/estimator/estimator.py``. Each batch
of ``fit`` is ``record()`` -> ``net(data)`` -> ``loss(pred, label)`` ->
``backward()`` -> ``trainer.step(batch size)``, with the step's host
time fed to the fit telemetry (``module.base_module._fit_telemetry``,
loop ``gluon_fit``) under one ``fit/epoch`` span an epoch and one
``fit/step`` span a batch, as ``Module.fit`` does.

The handlers (``event_handler``) run at their events. ``fit`` adds what
the caller left out: a ``MetricHandler`` over the training metrics, a
``ValidationHandler`` over ``val_data`` (when given) calling
:meth:`Estimator.evaluate`, a ``StoppingHandler`` after ``epochs`` and
a ``LoggingHandler``. ``batches`` caps each epoch's batches, as in the
JAX package. :meth:`Estimator.evaluate` uses copies of the training
metrics unless given its own (the JAX package resets and reuses the
training metrics themselves; the values returned are the same).

The device is ``context`` when given, else the net's parameters'; each
batch moves there.
"""
from __future__ import annotations

import copy
import time

import numpy as np
import torch

from .... import autograd
from .... import metric as metric_mod
from ....context import resolve_device
from ....module.base_module import _fit_telemetry
from ....telemetry import spans as _spans
from ...trainer import Trainer
from .event_handler import (BatchBegin, BatchEnd, EpochBegin, EpochEnd,
                            LoggingHandler, MetricHandler, StoppingHandler,
                            TrainBegin, TrainEnd, ValidationHandler)

__all__ = ["Estimator"]


class Estimator:
    """``net`` trained with ``loss`` (a Gluon loss block) by ``trainer``
    (default: SGD at lr 0.001 over all its parameters), scored by
    ``metrics`` (default: ``Accuracy``); ``initializer`` draws the
    net's weights anew when given."""

    def __init__(self, net, loss, metrics=None, initializer=None,
                 trainer=None, context=None):
        self.net = net
        self.loss = loss
        self.train_metrics = metrics if isinstance(metrics, list) else \
            ([metrics] if metrics else [metric_mod.Accuracy()])
        self.val_metrics = [copy.deepcopy(m) for m in self.train_metrics]
        if context is None:
            first = next(iter(net.parameters()), None)
            context = first.device if first is not None else None
        self.context = context if isinstance(context, list) else [context]
        self._device = resolve_device(self.context)
        if initializer is not None:
            net.initialize(initializer, force_reinit=True)
        self.trainer = trainer or Trainer(net.collect_params(), "sgd",
                                          {"learning_rate": 0.001})

    def _on_device(self, x):
        if isinstance(x, torch.Tensor):
            return x if x.device == self._device else x.to(self._device)
        return torch.as_tensor(np.asarray(x), device=self._device)

    def evaluate(self, val_data, val_metrics=None):
        """``[(name, value)]`` of the metrics over ``val_data``, the net
        in predict mode."""
        metrics = val_metrics or self.val_metrics
        for m in metrics:
            m.reset()
        for batch in val_data:
            data, label = (self._on_device(b) for b in batch[:2])
            pred = self.net(data)
            for m in metrics:
                m.update([label], [pred])
        return [m.get() for m in metrics]

    def _handlers(self, given, val_data, epochs):
        handlers = list(given or [])
        if not any(isinstance(h, MetricHandler) for h in handlers):
            handlers.append(MetricHandler(self.train_metrics))
        if val_data is not None and \
                not any(isinstance(h, ValidationHandler) for h in handlers):
            handlers.append(ValidationHandler(val_data, self.evaluate))
        if not any(isinstance(h, StoppingHandler) for h in handlers):
            handlers.append(StoppingHandler(max_epoch=epochs))
        if not any(isinstance(h, LoggingHandler) for h in handlers):
            handlers.append(LoggingHandler())
        handlers.sort(key=lambda h: getattr(h, "priority", 0))
        return {event: [h for h in handlers if isinstance(h, kind)]
                for event, kind in (("train_begin", TrainBegin),
                                    ("epoch_begin", EpochBegin),
                                    ("batch_begin", BatchBegin),
                                    ("batch_end", BatchEnd),
                                    ("epoch_end", EpochEnd),
                                    ("train_end", TrainEnd))}

    def fit(self, train_data, val_data=None, epochs=1, event_handlers=None,
            batches=None):
        """Train on ``train_data`` (batches of ``(data, label)``) until a
        handler stops it (by default after ``epochs`` epochs), at most
        ``batches`` batches an epoch. Returns the estimator."""
        on = self._handlers(event_handlers, val_data, epochs)
        step_ms, samples_per_sec = _fit_telemetry("gluon_fit")
        for h in on["train_begin"]:
            h.train_begin(self)
        epoch, stop = 0, False
        while not stop:
            for h in on["epoch_begin"]:
                h.epoch_begin(self)
            nbatch = 0
            with _spans.span("fit/epoch", loop="gluon_fit",
                             epoch=epoch) as ep_span:
                for batch in train_data:
                    for h in on["batch_begin"]:
                        h.batch_begin(self, batch=batch)
                    data, label = (self._on_device(b) for b in batch[:2])
                    t0 = time.perf_counter()
                    with _spans.span("fit/step", step=nbatch):
                        with autograd.record():
                            pred = self.net(data)
                            loss = self.loss(pred, label)
                        autograd.backward(loss)
                        self.trainer.step(data.shape[0])
                    dt = time.perf_counter() - t0
                    step_ms.observe(dt * 1e3)
                    if dt > 0:
                        samples_per_sec.set(data.shape[0] / dt)
                    nbatch += 1
                    # every handler sees the batch, then any may stop
                    ends = [h.batch_end(self, batch=batch, pred=pred,
                                        label=label, loss=loss)
                            for h in on["batch_end"]]
                    if any(ends):
                        stop = True
                        break
                    if batches is not None and nbatch >= batches:
                        break
                ep_span.set_attr(batches=nbatch)
            ends = [h.epoch_end(self, epoch) for h in on["epoch_end"]]
            stop = stop or any(ends)
            epoch += 1
        for h in on["train_end"]:
            h.train_end(self)
        return self
