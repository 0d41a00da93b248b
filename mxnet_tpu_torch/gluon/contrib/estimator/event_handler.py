"""Estimator event handlers (``gluon/contrib/estimator/event_handler.py``).

Port of ``mxnet_tpu/gluon/contrib/estimator/event_handler.py``, with
MXNet 1.6's behaviour: :class:`~.estimator.Estimator` calls every
handler at each event it subclasses (``train_begin``, ``epoch_begin``,
``batch_begin``, ``batch_end``, ``epoch_end``, ``train_end``), in the
order of their ``priority`` (lower first); a ``batch_end`` or
``epoch_end`` that returns True stops the training. ``batch_end`` gets
the keywords ``batch``, ``pred``, ``label`` and ``loss``; ``epoch_end``
the epoch's index.
"""
from __future__ import annotations

import logging
import math
import os

__all__ = ["BatchBegin", "BatchEnd", "CheckpointHandler",
           "EarlyStoppingHandler", "EpochBegin", "EpochEnd",
           "LoggingHandler", "MetricHandler", "StoppingHandler",
           "TrainBegin", "TrainEnd", "ValidationHandler"]


class TrainBegin:
    def train_begin(self, estimator, *args, **kwargs):
        pass


class TrainEnd:
    def train_end(self, estimator, *args, **kwargs):
        pass


class EpochBegin:
    def epoch_begin(self, estimator, *args, **kwargs):
        pass


class EpochEnd:
    def epoch_end(self, estimator, *args, **kwargs):
        return False


class BatchBegin:
    def batch_begin(self, estimator, *args, **kwargs):
        pass


class BatchEnd:
    def batch_end(self, estimator, *args, **kwargs):
        return False


class StoppingHandler(TrainBegin, BatchEnd, EpochEnd):
    """Stops after ``max_epoch`` epochs or ``max_batch`` batches in all,
    whichever comes first (None: no limit)."""

    def __init__(self, max_epoch=None, max_batch=None):
        self.max_epoch = max_epoch
        self.max_batch = max_batch
        self.current_batch = 0
        self.current_epoch = 0
        self.stop_training = False

    def train_begin(self, estimator, *args, **kwargs):
        self.current_batch = 0
        self.current_epoch = 0
        self.stop_training = False

    def batch_end(self, estimator, *args, **kwargs):
        self.current_batch += 1
        if self.max_batch is not None and \
                self.current_batch >= self.max_batch:
            self.stop_training = True
        return self.stop_training

    def epoch_end(self, estimator, *args, **kwargs):
        self.current_epoch += 1
        if self.max_epoch is not None and \
                self.current_epoch >= self.max_epoch:
            self.stop_training = True
        return self.stop_training


class MetricHandler(EpochBegin, BatchEnd):
    """Resets ``train_metrics`` at each epoch's start and updates them
    with each batch's labels and predictions."""

    priority = -1000

    def __init__(self, train_metrics):
        self.train_metrics = train_metrics or []

    def epoch_begin(self, estimator, *args, **kwargs):
        for metric in self.train_metrics:
            metric.reset()

    def batch_end(self, estimator, *args, **kwargs):
        for metric in self.train_metrics:
            metric.update([kwargs["label"]], [kwargs["pred"]])
        return False


class ValidationHandler(TrainBegin, BatchEnd, EpochEnd):
    """Calls ``eval_fn(val_data)`` every ``epoch_period`` epochs and, if
    given, every ``batch_period`` batches; ``results`` keeps what each
    call returned."""

    priority = -1000

    def __init__(self, val_data, eval_fn, epoch_period=1, batch_period=None):
        self.val_data = val_data
        self.eval_fn = eval_fn
        self.epoch_period = epoch_period
        self.batch_period = batch_period
        self.current_batch = 0
        self.current_epoch = 0
        self.results = []

    def train_begin(self, estimator, *args, **kwargs):
        self.current_batch = 0
        self.current_epoch = 0

    def batch_end(self, estimator, *args, **kwargs):
        self.current_batch += 1
        if self.batch_period and self.current_batch % self.batch_period == 0:
            self.results.append(self.eval_fn(self.val_data))
        return False

    def epoch_end(self, estimator, *args, **kwargs):
        self.current_epoch += 1
        if self.epoch_period and self.current_epoch % self.epoch_period == 0:
            self.results.append(self.eval_fn(self.val_data))
        return False


class LoggingHandler(TrainBegin, TrainEnd, EpochBegin, EpochEnd, BatchBegin,
                     BatchEnd):
    """Logs the training metrics at each epoch's end."""

    priority = math.inf

    def __init__(self, log_interval="epoch", metrics=None):
        self.log_interval = log_interval
        self.metrics = metrics

    def epoch_end(self, estimator, epoch=0, *args, **kwargs):
        vals = [m.get() for m in self.metrics or estimator.train_metrics]
        msg = " ".join(f"{n}={v:.4f}" for n, v in vals)
        logging.info("Epoch[%d] %s", epoch, msg)
        return False


class CheckpointHandler(TrainBegin, BatchEnd, EpochEnd):
    """Saves the net's parameters to ``model_dir`` as
    ``<model_prefix>-epoch<N>.params`` every ``epoch_period`` epochs."""

    def __init__(self, model_dir, model_prefix="model", monitor=None,
                 verbose=0, save_best=False, mode="auto", epoch_period=1,
                 batch_period=None, max_checkpoints=5,
                 resume_from_checkpoint=False):
        self.model_dir = model_dir
        self.model_prefix = model_prefix
        self.epoch_period = epoch_period

    def epoch_end(self, estimator, epoch=0, *args, **kwargs):
        if self.epoch_period and (epoch + 1) % self.epoch_period == 0:
            os.makedirs(self.model_dir, exist_ok=True)
            estimator.net.save_parameters(os.path.join(
                self.model_dir, f"{self.model_prefix}-epoch{epoch}.params"))
        return False


class EarlyStoppingHandler(TrainBegin, EpochEnd, TrainEnd):
    """Stops when the metric ``monitor`` has not improved by more than
    ``min_delta`` for ``patience`` epochs in a row (``mode``: "min",
    "max", or "auto": "max" for accuracies, else "min")."""

    def __init__(self, monitor, min_delta=0, patience=0, mode="auto",
                 baseline=None):
        self.monitor = monitor
        self.min_delta = abs(min_delta)
        self.patience = patience
        if mode == "auto":
            mode = "max" if "acc" in monitor.get()[0] else "min"
        self.mode = mode
        self.baseline = baseline
        self.wait = 0
        self.stopped_epoch = 0
        self.best = None

    def train_begin(self, estimator, *args, **kwargs):
        self.wait = 0
        self.stopped_epoch = 0
        self.best = self.baseline

    def _improved(self, value):
        if self.best is None:
            return True
        if self.mode == "max":
            return value > self.best + self.min_delta
        return value < self.best - self.min_delta

    def epoch_end(self, estimator, epoch=0, *args, **kwargs):
        value = self.monitor.get()[1]
        if self._improved(value):
            self.best, self.wait = value, 0
            return False
        self.wait += 1
        if self.wait >= self.patience:
            self.stopped_epoch = epoch
            return True
        return False
