"""BaseModule: the ``fit``/``score``/``predict`` training loop (port of
``mxnet_tpu/module/base_module.py``, MXNet's
``python/mxnet/module/base_module.py``).

``predict`` merges the outputs of many batches: each forward's outputs
are the executor's own copies (``executor``), so a batch's outputs
stay valid after the next batch runs. ``fit`` records a step-time
histogram and a samples/s gauge per loop (``telemetry.registry``), an
epoch span and a step span per batch (``telemetry.spans``) and a
``fit_epoch`` event (``telemetry.events``)."""
from __future__ import annotations

import logging
import time

from .. import metric as _metric
from ..model import BatchEndParam
from ..telemetry import events as _events
from ..telemetry import spans as _spans
from ..telemetry.registry import REGISTRY as _REGISTRY

__all__ = ["BaseModule"]


def _fit_telemetry(loop):
    """(step-time histogram child, samples/sec gauge child) for a fit
    loop — one family shared by module and gluon loops, labeled by
    which loop fed it."""
    hist = _REGISTRY.histogram(
        "mxnet_tpu_train_step_ms",
        "host wall per train step (fwd+bwd+update dispatch)", ("loop",))
    gauge = _REGISTRY.gauge(
        "mxnet_tpu_train_samples_per_sec",
        "most recent train-loop throughput", ("loop",))
    return hist.labels(loop=loop), gauge.labels(loop=loop)


class BaseModule:
    def __init__(self, logger=logging):
        self.logger = logger
        self.binded = False
        self.for_training = False
        self.params_initialized = False
        self.optimizer_initialized = False
        self._symbol = None

    # -- abstract surface --------------------------------------------------
    def bind(self, *args, **kwargs):
        raise NotImplementedError

    def init_params(self, *args, **kwargs):
        raise NotImplementedError

    def init_optimizer(self, *args, **kwargs):
        raise NotImplementedError

    def forward(self, data_batch, is_train=None):
        raise NotImplementedError

    def backward(self, out_grads=None):
        raise NotImplementedError

    def update(self):
        raise NotImplementedError

    def update_metric(self, eval_metric, labels, pre_sliced=False):
        raise NotImplementedError

    def get_outputs(self, merge_multi_context=True):
        raise NotImplementedError

    def get_params(self):
        raise NotImplementedError

    # -- derived helpers ---------------------------------------------------
    @property
    def symbol(self):
        return self._symbol

    def forward_backward(self, data_batch):
        self.forward(data_batch, is_train=True)
        self.backward()

    def score(self, eval_data, eval_metric, num_batch=None,
              batch_end_callback=None, score_end_callback=None, reset=True,
              epoch=0, sparse_row_id_fn=None):
        assert self.binded and self.params_initialized
        if reset:
            eval_data.reset()
        if not isinstance(eval_metric, _metric.EvalMetric):
            eval_metric = _metric.create(eval_metric)
        eval_metric.reset()
        for nbatch, eval_batch in enumerate(eval_data):
            if num_batch is not None and nbatch == num_batch:
                break
            self.forward(eval_batch, is_train=False)
            self.update_metric(eval_metric, eval_batch.label)
            if batch_end_callback is not None:
                param = BatchEndParam(epoch=epoch, nbatch=nbatch,
                                      eval_metric=eval_metric, locals=locals())
                for cb in _as_list(batch_end_callback):
                    cb(param)
        return eval_metric.get_name_value()

    def predict(self, eval_data, num_batch=None, merge_batches=True,
                reset=True, always_output_list=False, sparse_row_id_fn=None):
        from .. import ndarray as nd
        assert self.binded and self.params_initialized
        if reset:
            eval_data.reset()
        output_list = []
        for nbatch, eval_batch in enumerate(eval_data):
            if num_batch is not None and nbatch == num_batch:
                break
            self.forward(eval_batch, is_train=False)
            pad = eval_batch.pad or 0
            outs = [out[0:out.shape[0] - pad] for out in self.get_outputs()]
            output_list.append(outs)
        if not output_list:
            return output_list
        if merge_batches:
            num_outputs = len(output_list[0])
            merged = [nd.concat(*[o[i] for o in output_list], dim=0)
                      for i in range(num_outputs)]
            if num_outputs == 1 and not always_output_list:
                return merged[0]
            return merged
        return output_list

    def fit(self, train_data, eval_data=None, eval_metric="acc",
            epoch_end_callback=None, batch_end_callback=None,
            kvstore="local", optimizer="sgd",
            optimizer_params=(("learning_rate", 0.01),),
            eval_end_callback=None, eval_batch_end_callback=None,
            initializer=None, arg_params=None, aux_params=None,
            allow_missing=False, force_rebind=False, force_init=False,
            begin_epoch=0, num_epoch=None, validation_metric=None,
            monitor=None, sparse_row_id_fn=None):
        """The classic Module.fit loop (reference base_module.py fit)."""
        from ..initializer import Uniform
        assert num_epoch is not None, "please specify number of epochs"
        initializer = initializer or Uniform(0.01)

        self.bind(data_shapes=train_data.provide_data,
                  label_shapes=train_data.provide_label,
                  for_training=True, force_rebind=force_rebind)
        if monitor is not None:
            self.install_monitor(monitor)
        self.init_params(initializer=initializer, arg_params=arg_params,
                         aux_params=aux_params, allow_missing=allow_missing,
                         force_init=force_init)
        self.init_optimizer(kvstore=kvstore, optimizer=optimizer,
                            optimizer_params=optimizer_params)
        if validation_metric is None:
            validation_metric = eval_metric
        if not isinstance(eval_metric, _metric.EvalMetric):
            eval_metric = _metric.create(eval_metric)

        step_ms, samples_per_sec = _fit_telemetry("module_fit")
        for epoch in range(begin_epoch, num_epoch):
            tic = time.perf_counter()
            eval_metric.reset()
            nbatch = 0
            nsample = 0
            train_data.reset()
            # the epoch span is a tail-sampled local root (epochs are
            # slow, so they're kept); per-step child spans decompose
            # where the epoch went, capped by the recorder's
            # max-spans-per-trace bound
            with _spans.span("fit/epoch", loop="module_fit",
                             epoch=epoch) as _ep:
                for data_batch in train_data:
                    if monitor is not None:
                        monitor.tic()
                    t0 = time.perf_counter()
                    with _spans.span("fit/step", step=nbatch):
                        self.forward_backward(data_batch)
                        self.update()
                    # host wall of the dispatch; under async execution
                    # the device backpressure folds in over
                    # steady-state steps
                    dt = time.perf_counter() - t0
                    step_ms.observe(dt * 1e3)
                    try:
                        bsz = data_batch.data[0].shape[0]
                    except (AttributeError, IndexError, TypeError):
                        bsz = 0
                    if bsz and dt > 0:
                        samples_per_sec.set(bsz / dt)
                        nsample += bsz
                    self.update_metric(eval_metric, data_batch.label)
                    if monitor is not None:
                        monitor.toc_print()
                    if batch_end_callback is not None:
                        param = BatchEndParam(epoch=epoch, nbatch=nbatch,
                                              eval_metric=eval_metric,
                                              locals=locals())
                        for cb in _as_list(batch_end_callback):
                            cb(param)
                    nbatch += 1
                _ep.set_attr(batches=nbatch, samples=nsample)

            for name, val in eval_metric.get_name_value():
                self.logger.info("Epoch[%d] Train-%s=%f", epoch, name, val)
            self.logger.info("Epoch[%d] Time cost=%.3f", epoch,
                             time.perf_counter() - tic)
            _events.emit("fit_epoch", loop="module_fit", epoch=epoch,
                         batches=nbatch, samples=nsample,
                         seconds=round(time.perf_counter() - tic, 3))

            arg_p, aux_p = self.get_params()
            self.set_params(arg_p, aux_p, allow_missing=False, force_init=True,
                            allow_extra=False)
            if epoch_end_callback is not None:
                for cb in _as_list(epoch_end_callback):
                    cb(epoch, self.symbol, arg_p, aux_p)

            if eval_data is not None:
                res = self.score(eval_data, validation_metric,
                                 score_end_callback=eval_end_callback,
                                 batch_end_callback=eval_batch_end_callback,
                                 epoch=epoch)
                for name, val in res:
                    self.logger.info("Epoch[%d] Validation-%s=%f", epoch, name, val)

    def set_params(self, arg_params, aux_params, allow_missing=False,
                   force_init=True, allow_extra=False):
        self.init_params(initializer=None, arg_params=arg_params,
                         aux_params=aux_params, allow_missing=allow_missing,
                         force_init=force_init, allow_extra=allow_extra)

    def install_monitor(self, mon):
        raise NotImplementedError

    def get_input_grads(self, merge_multi_context=True):
        raise NotImplementedError


def _as_list(obj):
    if isinstance(obj, (list, tuple)):
        return obj
    return [obj]
