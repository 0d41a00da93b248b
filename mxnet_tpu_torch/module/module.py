"""Module: symbolic training on one device (port of
``mxnet_tpu/module/module.py``, MXNet's ``python/mxnet/module/
module.py``).

:meth:`Module.bind` infers every argument's shape from the data and
label shapes and binds one :class:`~..executor.Executor` (one CUDA
graph per binding key on the card); :meth:`Module.init_params`,
:meth:`~.base_module.BaseModule.set_params` and :meth:`Module.update`
write into the bound arrays in place, which the graphs read. The
optimizer is the port's (``optimizer.get_updater``), keyed by parameter
index. A context list of more than one device raises ``ValueError``:
the JAX module's data parallelism (one executor per device, a fused
all-reduce) waits for ROADMAP's multi-GPU item.
"""
from __future__ import annotations

import logging

import numpy as np
import torch

from .. import kvstore as _kvstore_mod
from .. import optimizer as opt
from ..base import MXNetError
from ..context import cpu, current_context
from ..initializer import InitDesc
from .base_module import BaseModule

__all__ = ["Module"]


class Module(BaseModule):
    def __init__(self, symbol, data_names=("data",),
                 label_names=("softmax_label",), logger=logging, context=None,
                 work_load_list=None, fixed_param_names=None,
                 state_names=None, group2ctxs=None, compression_params=None):
        super().__init__(logger)
        self._symbol = symbol
        self._data_names = list(data_names or [])
        self._label_names = list(label_names or [])
        ctx = context if context is not None else current_context()
        if isinstance(ctx, (list, tuple)):
            if len(ctx) != 1:
                raise ValueError(
                    f"context {list(ctx)}: the port's Module runs on one "
                    f"device; data parallelism over a context list waits "
                    f"for ROADMAP 'Multi-GPU'")
            ctx = ctx[0]
        self._context = ctx
        self._fixed_param_names = list(fixed_param_names or [])
        arg_names = symbol.list_arguments()
        self._param_names = [n for n in arg_names
                             if n not in self._data_names
                             and n not in self._label_names]
        self._aux_names = symbol.list_auxiliary_states()
        self._arg_params = None
        self._aux_params = None
        self._exec = None
        self._optimizer = None
        self._kvstore = None
        self._updater = None
        self._data_shapes = None
        self._label_shapes = None

    @property
    def data_names(self):
        return self._data_names

    @property
    def label_names(self):
        return self._label_names

    @property
    def output_names(self):
        return self._symbol.list_outputs()

    @property
    def data_shapes(self):
        return self._data_shapes

    @property
    def label_shapes(self):
        return self._label_shapes

    @property
    def output_shapes(self):
        assert self.binded
        return list(zip(self.output_names,
                        [tuple(o.shape) for o in self._exec.outputs]))

    def bind(self, data_shapes, label_shapes=None, for_training=True,
             inputs_need_grad=False, force_rebind=False, shared_module=None,
             grad_req="write"):
        if self.binded and not force_rebind:
            self.logger.warning("Already bound, ignoring bind()")
            return
        from .. import ndarray as nd

        self._data_shapes = list(data_shapes)
        self._label_shapes = list(label_shapes) if label_shapes else None
        self.for_training = for_training
        self.inputs_need_grad = inputs_need_grad

        shape_kwargs = {}
        for desc in self._data_shapes:
            shape_kwargs[desc[0]] = desc[1]
        if self._label_shapes:
            for desc in self._label_shapes:
                shape_kwargs[desc[0]] = desc[1]

        arg_shapes, _, _ = self._symbol.infer_shape(**shape_kwargs)
        if arg_shapes is None:
            raise MXNetError(f"cannot infer shapes from {shape_kwargs}")
        args, grads, req = {}, {}, {}
        for name, shape in zip(self._symbol.list_arguments(), arg_shapes):
            args[name] = nd.zeros(shape, ctx=self._context)
            if for_training and name in self._param_names and \
                    name not in self._fixed_param_names:
                grads[name] = nd.zeros(shape, ctx=self._context)
                req[name] = grad_req if isinstance(grad_req, str) \
                    else grad_req.get(name, "write")
            elif inputs_need_grad and name in self._data_names:
                grads[name] = nd.zeros(shape, ctx=self._context)
                req[name] = "write"
            else:
                req[name] = "null"
        self._exec = self._symbol.bind(self._context, args, grads, req)
        self._execs = [self._exec]
        self.binded = True
        if shared_module is not None and shared_module.params_initialized:
            arg_p, aux_p = shared_module.get_params()
            self.set_params(arg_p, aux_p)

    def init_params(self, initializer=None, arg_params=None, aux_params=None,
                    allow_missing=False, force_init=False, allow_extra=False):
        if self.params_initialized and not force_init:
            return
        assert self.binded, "call bind before initializing the parameters"
        from ..initializer import Uniform
        if initializer is None and not (arg_params or aux_params):
            initializer = Uniform(0.01)
        # one generator for the call, seeded from the CPU's (so
        # mx.random.seed decides the draws)
        rng = np.random.default_rng(
            int(torch.randint(0, 2 ** 62, (1,)).item()))
        attrs = self._symbol.attr_dict()
        for name in self._param_names:
            arr = self._exec.arg_dict[name]
            if arg_params is not None and name in arg_params:
                _copy_into(arr, arg_params[name])
            elif initializer is not None:
                # per-variable __init__ attrs (mx.rnn LSTMCell's LSTMBias
                # forget-gate offset) override the global initializer
                initializer(InitDesc(name, attrs.get(name)), arr, rng)
            elif not allow_missing:
                raise MXNetError(f"parameter {name} missing and no "
                                 f"initializer given")
        for name in self._aux_names:
            arr = self._exec.aux_dict.get(name)
            if arr is None:
                continue
            if aux_params is not None and name in aux_params:
                _copy_into(arr, aux_params[name])
            elif initializer is not None:
                initializer(InitDesc(name), arr, rng)
        self.params_initialized = True

    def get_params(self):
        assert self.binded and self.params_initialized
        arg_params = {n: self._exec.arg_dict[n].copyto(cpu())
                      for n in self._param_names}
        aux_params = {n: self._exec.aux_dict[n].copyto(cpu())
                      for n in self._aux_names if n in self._exec.aux_dict}
        return arg_params, aux_params

    def init_optimizer(self, kvstore="local", optimizer="sgd",
                       optimizer_params=(("learning_rate", 0.01),),
                       force_init=False):
        assert self.binded and self.params_initialized
        if self.optimizer_initialized and not force_init:
            return
        if isinstance(optimizer, str):
            optimizer_params = dict(optimizer_params)
            idx2name = dict(enumerate(self._param_names))
            optimizer = opt.create(optimizer, param_idx2name=idx2name,
                                   **optimizer_params)
        self._optimizer = optimizer
        self._updater = opt.get_updater(optimizer)
        if kvstore:
            kv = kvstore if not isinstance(kvstore, str) \
                else _kvstore_mod.create(kvstore)
            self._kvstore = kv
            for i, name in enumerate(self._param_names):
                kv.init(i, self._exec.arg_dict[name])
        self.optimizer_initialized = True

    def forward(self, data_batch, is_train=None):
        assert self.binded and self.params_initialized
        if is_train is None:
            is_train = self.for_training
        bindings = {}
        for name, arr in zip(self._data_names, data_batch.data):
            bindings[name] = arr
        if data_batch.label:
            for name, arr in zip(self._label_names, data_batch.label):
                bindings[name] = arr
        self._exec.forward(is_train=is_train, **bindings)

    def backward(self, out_grads=None):
        assert self.binded and self.params_initialized
        self._exec.backward(out_grads=out_grads)

    def update(self):
        """One optimizer step on every parameter that has a gradient,
        in place (the local kvstore's pushpull first, as the JAX
        module's single-device path does)."""
        assert self.binded and self.params_initialized and \
            self.optimizer_initialized
        keys, grads = [], []
        for i, name in enumerate(self._param_names):
            g = self._exec.grad_dict.get(name)
            if g is not None:
                keys.append(i)
                grads.append([g])
        if keys and self._kvstore is not None:
            self._kvstore.pushpull(keys, grads, out=grads)
        for i, name in enumerate(self._param_names):
            grad = self._exec.grad_dict.get(name)
            if grad is not None:
                self._updater(i, grad, self._exec.arg_dict[name])

    def get_outputs(self, merge_multi_context=True):
        assert self.binded and self.params_initialized
        return list(self._exec.outputs)

    def get_input_grads(self, merge_multi_context=True):
        assert self.binded and self.inputs_need_grad
        return [self._exec.grad_dict[n] for n in self._data_names]

    def update_metric(self, eval_metric, labels, pre_sliced=False):
        eval_metric.update(labels, self.get_outputs())

    def install_monitor(self, mon):
        assert self.binded
        mon.install(self._exec)

    def save_checkpoint(self, prefix, epoch, save_optimizer_states=False,
                        remove_amp_cast=True):
        from ..model import save_checkpoint
        arg_params, aux_params = self.get_params()
        save_checkpoint(prefix, epoch, self._symbol, arg_params, aux_params)
        if save_optimizer_states:
            self.save_optimizer_states(f"{prefix}-{epoch:04d}.states")

    def save_optimizer_states(self, fname):
        assert self.optimizer_initialized
        with open(fname, "wb") as f:
            f.write(self._updater.get_states())

    def load_optimizer_states(self, fname):
        assert self.optimizer_initialized
        with open(fname, "rb") as f:
            self._updater.set_states(f.read())

    @staticmethod
    def load(prefix, epoch, load_optimizer_states=False, **kwargs):
        """A module of the checkpoint's symbol; its arrays wait in
        ``_preloaded_params`` for ``init_params(arg_params=...,
        aux_params=...)``, as in the JAX package."""
        from ..model import load_checkpoint
        sym, args, auxs = load_checkpoint(prefix, epoch)
        mod = Module(symbol=sym, **kwargs)
        mod._arg_params = args
        mod._aux_params = auxs
        mod.params_initialized = False
        mod._preloaded_params = (args, auxs)
        return mod


@torch.no_grad()
def _copy_into(dst, src):
    dst.copy_(torch.as_tensor(src))
