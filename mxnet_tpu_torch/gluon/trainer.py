"""Gluon ``Trainer``: applies an optimizer to a set of Parameters.

Port of ``mxnet_tpu/gluon/trainer.py`` for one card. Same contract:
``Trainer(params, optimizer, optimizer_params, kvstore=...,
update_on_kvstore=...)``, then per batch ``step(batch_size)`` = reduce
the gradients across replicas and apply the optimizer with
``rescale_grad = scale / batch_size`` ON TOP of whatever normalisation
the loss already did (``scale`` is the ``rescale_grad`` given in
``optimizer_params``, 1 by default).

``kvstore`` is ``None``, a store type name (``"device"``, ``"local"``,
``"nccl"``, ...; ``kvstore.create``) or a ``KVStore`` object; the
store is made at the first step, as in the JAX package (the
distributed types are not ported: ROADMAP 'Multi-GPU'). One card holds
one replica, so there is nothing to reduce: with ``update_on_kvstore``
off (the default for one worker, as in the JAX package) the optimizer
runs here, over all dense parameters in one multi-tensor call, and the
store holds no copy of the weights (the JAX store takes one it never
reads on one worker); :meth:`_row_sparse_pull` then reads the
parameter's own rows. With ``update_on_kvstore=True`` the store holds
the weights and runs the optimizer: ``step`` pushes each gradient and
pulls each weight back, and ``allreduce_grads``/``update`` refuse, as
the JAX Trainer's assertions do. A parameter's gradient is a dense
tensor (``grad_stype="row_sparse"`` is recorded, as the JAX package
records it), so the JAX ``_update``'s branch for a row_sparse gradient
has no counterpart: row_sparse gradients reach an optimizer through
``KVStore.push``. The store's type is checked when the Trainer is made
(an unknown or distributed type raises then). ``ignore_stale_grad`` is
taken and, as in the JAX package, checks nothing.

:meth:`Trainer.save_states` writes the port's own ``.states`` file (the
store's, with ``update_on_kvstore``): a pickle of the optimizer states
(as CPU tensors, so a file written on the card loads on the CPU and the
reverse) and the optimizer with its update counts.
:meth:`Trainer.load_states` puts each state on its weight's device.
The JAX package's ``.states`` pickles its own classes and cannot be
read without importing it: loading one raises ``MXNetError``.
Parameters whose shapes are deferred join the store and take their
optimizer states at the first ``step`` after the forward gave them
shapes.
"""
from __future__ import annotations

import torch

from .. import kvstore as _kvstore
from .. import optimizer as opt
from .parameter import (DeferredInitializationError, Parameter,
                        ParameterDict, is_deferred)

__all__ = ["Trainer"]


class Trainer:
    """Applies ``optimizer`` to ``params`` (a ``ParameterDict``, a dict
    or a list of :class:`~.parameter.Parameter`)."""

    def __init__(self, params, optimizer, optimizer_params=None,
                 kvstore="device", compression_params=None,
                 update_on_kvstore=None):
        if isinstance(params, (dict, ParameterDict)):
            params = list(params.values())
        if not isinstance(params, (list, tuple)):
            raise ValueError(f"First argument must be a list or dict of "
                             f"Parameters, got {type(params)}.")
        for p in params:
            if not isinstance(p, Parameter):
                raise ValueError(f"First argument must be a list or dict "
                                 f"of Parameters, got list of {type(p)}.")
        if isinstance(kvstore, str):
            _kvstore.create(kvstore)    # an unknown or dist type raises
        self._params = list(params)
        self._param2idx = {p.name: i for i, p in enumerate(self._params)}
        optimizer_params = dict(optimizer_params or {})
        self._scale = float(optimizer_params.get("rescale_grad", 1.0))
        param_dict = dict(enumerate(self._params))
        if isinstance(optimizer, opt.Optimizer):
            if optimizer_params:
                raise ValueError("optimizer_params must be None if "
                                 "optimizer is an Optimizer instance")
            self._optimizer = optimizer
            self._optimizer.param_dict = param_dict
        else:
            self._optimizer = opt.create(optimizer, param_dict=param_dict,
                                         **optimizer_params)
        self._updater = opt.get_updater(self._optimizer)
        self._compression_params = compression_params
        self._kvstore_params = {"kvstore": kvstore,
                                "update_on_kvstore": update_on_kvstore}
        self._kv_initialized = False
        self._kvstore = None
        self._update_on_kvstore = None
        self._params_to_init = list(self._params)

    def _init_kvstore(self):
        kv = self._kvstore_params["kvstore"]
        update_on_kvstore = self._kvstore_params["update_on_kvstore"]
        if kv is None:
            self._kvstore, self._update_on_kvstore = None, False
        else:
            kv = _kvstore.create(kv) if isinstance(kv, str) else kv
            if update_on_kvstore is None:
                update_on_kvstore = kv.num_workers > 1
            self._kvstore = kv
            self._update_on_kvstore = bool(update_on_kvstore)
            if self._compression_params:
                kv.set_gradient_compression(self._compression_params)
            if self._update_on_kvstore:
                kv.set_optimizer(self._optimizer)
        self._kv_initialized = True

    def _init_params(self):
        """Give the store each parameter whose shape is known (only
        when it holds the weights: ``update_on_kvstore``)."""
        pending = []
        for p in self._params_to_init:
            if is_deferred(p._tensor):
                pending.append(p)
            elif self._kvstore is not None and self._update_on_kvstore:
                self._kvstore.init(self._param2idx[p.name], p.data())
        self._params_to_init = pending

    def _ready(self):
        if not self._kv_initialized:
            self._init_kvstore()
        if self._params_to_init:
            self._init_params()

    @property
    def learning_rate(self):
        return self._optimizer.learning_rate

    @property
    def optimizer(self):
        return self._optimizer

    def set_learning_rate(self, lr):
        self._optimizer.set_learning_rate(lr)

    def _row_sparse_pull(self, parameter, out, row_id, full_idx=False):
        """The rows ``row_id`` of ``parameter``'s weight into ``out``
        (``KVStore.row_sparse_pull``'s destinations)."""
        self._ready()
        if self._kvstore is not None and self._update_on_kvstore:
            self._kvstore.row_sparse_pull(self._param2idx[parameter.name],
                                          out=out, row_ids=row_id)
        else:
            _kvstore.pull_rows(parameter.data(), out, row_id)

    def step(self, batch_size, ignore_stale_grad=False):
        """Reduce the gradients (nothing to reduce on one card; pushed
        to the store with ``update_on_kvstore``), then update with
        ``rescale_grad = scale / batch_size``."""
        self._ready()
        self._optimizer.rescale_grad = self._scale / batch_size
        self._allreduce_grads()
        self._update()

    def allreduce_grads(self):
        """Sum the gradients across replicas: one card has one."""
        self._ready()
        assert not (self._kvstore and self._update_on_kvstore), \
            "allreduce_grads() when parameters are updated on kvstore " \
            "is not supported. Try setting `update_on_kvstore` to False."
        self._allreduce_grads()

    def _allreduce_grads(self):
        if self._kvstore is not None and self._update_on_kvstore:
            for i, p in enumerate(self._params):
                if p.grad_req != "null":
                    self._kvstore.push(i, p.list_grad())

    def update(self, batch_size, ignore_stale_grad=False):
        """The optimizer step alone (after :meth:`allreduce_grads`)."""
        self._ready()
        assert not (self._kvstore and self._update_on_kvstore), \
            "update() when parameters are updated on kvstore is not " \
            "supported. Try setting `update_on_kvstore` to False."
        self._optimizer.rescale_grad = self._scale / batch_size
        self._update()

    def _update(self):
        idx, weights, grads = [], [], []
        on_kv = self._kvstore is not None and self._update_on_kvstore
        for i, p in enumerate(self._params):
            if p.grad_req == "null":
                continue
            w = p._tensor
            if is_deferred(w):
                raise DeferredInitializationError(
                    f"Parameter '{p.name}' has no shape yet: run a "
                    f"forward before the first step")
            if on_kv:
                # the store updated its copy; the weight takes it back
                self._kvstore.pull(i, p.list_data())
                continue
            if w.grad is None:
                w.grad = torch.zeros_like(w)
            idx.append(i)
            weights.append(w)
            grads.append(w.grad)
        if idx:
            self._updater.update_multi(idx, grads, weights)

    def save_states(self, fname):
        """Write the optimizer states (and the optimizer, with its
        update counts) to ``fname``."""
        self._ready()
        if self._update_on_kvstore and self._kvstore is not None:
            self._kvstore.save_optimizer_states(fname, dump_optimizer=True)
            return
        with open(fname, "wb") as f:
            f.write(self._updater.get_states(dump_optimizer=True))

    def load_states(self, fname):
        """Read a file of :meth:`save_states`; each state goes to its
        weight's device."""
        self._ready()
        if self._update_on_kvstore and self._kvstore is not None:
            self._kvstore.load_optimizer_states(fname)
            self._optimizer = self._kvstore._updater.optimizer
        else:
            with open(fname, "rb") as f:
                self._updater.set_states(f.read())
            for i, state in self._updater.states.items():
                self._updater.states[i] = opt.optimizer.move_state(
                    state, self._params[i]._tensor.device)
            # adopt the restored optimizer: its update counts carry
            # Adam's bias correction and the lr schedule on
            self._optimizer = self._updater.optimizer
        self._optimizer.param_dict = dict(enumerate(self._params))
