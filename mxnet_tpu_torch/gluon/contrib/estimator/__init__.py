"""``gluon.contrib.estimator``: ``Estimator`` and its event handlers
(port of ``mxnet_tpu/gluon/contrib/estimator``)."""
from __future__ import annotations

from .estimator import Estimator
from .event_handler import (BatchBegin, BatchEnd, CheckpointHandler,
                            EarlyStoppingHandler, EpochBegin, EpochEnd,
                            LoggingHandler, MetricHandler, StoppingHandler,
                            TrainBegin, TrainEnd, ValidationHandler)

__all__ = ["BatchBegin", "BatchEnd", "CheckpointHandler",
           "EarlyStoppingHandler", "Estimator", "EpochBegin", "EpochEnd",
           "LoggingHandler", "MetricHandler", "StoppingHandler",
           "TrainBegin", "TrainEnd", "ValidationHandler"]
