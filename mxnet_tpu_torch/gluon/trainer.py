"""Gluon ``Trainer``: applies an optimizer to a set of Parameters.

Port of ``mxnet_tpu/gluon/trainer.py`` for one card. Same contract:
``Trainer(params, optimizer, optimizer_params, kvstore=...)``, then
per batch ``step(batch_size)`` = reduce the gradients across replicas
and apply the optimizer with ``rescale_grad = scale / batch_size`` ON
TOP of whatever normalisation the loss already did (``scale`` is the
``rescale_grad`` given in ``optimizer_params``, 1 by default).

One card holds one replica, so ``kvstore`` of ``None``, ``"device"`` or
``"local"`` reduces nothing, as the JAX ``_allreduce_grads`` does with
one replica. The distributed stores (``dist_sync``, ``dist_async``,
...) are not ported yet and raise (ROADMAP 'Multi-GPU').
``ignore_stale_grad`` is taken and, as in the JAX package, checks
nothing: every parameter with a gradient is updated.

:meth:`Trainer.save_states` writes the port's own ``.states`` file: a
pickle of the optimizer states (as CPU tensors, so a file written on
the card loads on the CPU and the reverse) and the optimizer with its
update counts. :meth:`Trainer.load_states` puts each state on its
weight's device. The JAX package's ``.states`` pickles its own classes
and cannot be read without importing it: loading one raises
``MXNetError``. Parameters whose shapes are deferred take their
optimizer states at the first ``step``, after the forward gave them
shapes.
"""
from __future__ import annotations

import torch

from .. import optimizer as opt
from .parameter import (DeferredInitializationError, Parameter,
                        ParameterDict, is_deferred)

__all__ = ["Trainer"]

_LOCAL_KVSTORES = (None, "device", "local")


class Trainer:
    """Applies ``optimizer`` to ``params`` (a ``ParameterDict``, a dict
    or a list of :class:`~.parameter.Parameter`)."""

    def __init__(self, params, optimizer, optimizer_params=None,
                 kvstore="device"):
        if isinstance(params, (dict, ParameterDict)):
            params = list(params.values())
        if not isinstance(params, (list, tuple)):
            raise ValueError(f"First argument must be a list or dict of "
                             f"Parameters, got {type(params)}.")
        for p in params:
            if not isinstance(p, Parameter):
                raise ValueError(f"First argument must be a list or dict "
                                 f"of Parameters, got list of {type(p)}.")
        if not (kvstore in _LOCAL_KVSTORES
                or getattr(kvstore, "type", None) in ("device", "local")):
            if isinstance(kvstore, str) and kvstore.startswith("dist"):
                raise NotImplementedError(
                    f"kvstore {kvstore!r}: the distributed key-value stores "
                    f"are not ported yet (ROADMAP 'Multi-GPU'); use "
                    f"kvstore='device' on one card")
            raise ValueError(f"unknown kvstore {kvstore!r}: one card takes "
                             f"None, 'device' or 'local'")
        self._params = list(params)
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

    @property
    def learning_rate(self):
        return self._optimizer.learning_rate

    @property
    def optimizer(self):
        return self._optimizer

    def set_learning_rate(self, lr):
        self._optimizer.set_learning_rate(lr)

    def step(self, batch_size, ignore_stale_grad=False):
        """Reduce the gradients (nothing to reduce on one card), then
        update with ``rescale_grad = scale / batch_size``."""
        self._optimizer.rescale_grad = self._scale / batch_size
        self.allreduce_grads()
        self._update()

    def allreduce_grads(self):
        """Sum the gradients across replicas: one card has one."""

    def update(self, batch_size, ignore_stale_grad=False):
        """The optimizer step alone (after :meth:`allreduce_grads`)."""
        self._optimizer.rescale_grad = self._scale / batch_size
        self._update()

    def _update(self):
        idx, weights, grads = [], [], []
        for i, p in enumerate(self._params):
            if p.grad_req == "null":
                continue
            w = p._tensor
            if is_deferred(w):
                raise DeferredInitializationError(
                    f"Parameter '{p.name}' has no shape yet: run a "
                    f"forward before the first step")
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
        with open(fname, "wb") as f:
            f.write(self._updater.get_states(dump_optimizer=True))

    def load_states(self, fname):
        """Read a file of :meth:`save_states`; each state goes to its
        weight's device."""
        with open(fname, "rb") as f:
            self._updater.set_states(f.read())
        for i, state in self._updater.states.items():
            self._updater.states[i] = opt.optimizer.move_state(
                state, self._params[i]._tensor.device)
        # adopt the restored optimizer: its update counts carry Adam's
        # bias correction and the lr schedule on
        self._optimizer = self._updater.optimizer
        self._optimizer.param_dict = dict(enumerate(self._params))
