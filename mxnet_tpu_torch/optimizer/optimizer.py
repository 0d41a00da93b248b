"""Optimizers: ``Optimizer``, ``SGD``, ``Adam``, ``AdamW``, the registry
and the ``Updater``.

Port of ``mxnet_tpu/optimizer/optimizer.py`` (the optimizers BERT
training uses). Same surface and semantics: a name registry
(``create("adam", ...)``), per-parameter state made on first update,
index-keyed ``update`` with per-index update counts (``num_update`` is
their maximum, and what ``lr_scheduler`` reads), ``rescale_grad``,
``wd``, ``clip_gradient``, per-parameter ``lr_mult``/``wd_mult`` (from
the Trainer's Parameters, else from ``set_lr_mult``/``set_wd_mult``).
The updates are the in-place ops of ``ndarray.op_impl_optimizer``.

MXNet's Adam is not ``torch.optim.Adam``: it folds the bias correction
into the learning rate (``lr * sqrt(1 - beta2**t) / (1 - beta1**t)``),
keeps epsilon outside the uncorrected square root, and adds ``wd *
weight`` to the gradient; AdamW adds it to the update instead. The
weights differ, so the port keeps MXNet's math.
"""
from __future__ import annotations

import math
import pickle
import pickletools

import torch

from ..base import MXNetError
from ..ndarray import op_impl_optimizer as _ops

__all__ = ["Adam", "AdamW", "Optimizer", "SGD", "Updater", "create",
           "get_updater", "register"]

_REGISTRY = {}


def register(klass):
    """Register an optimizer class under its lower-case name."""
    _REGISTRY[klass.__name__.lower()] = klass
    return klass


def create(name, **kwargs):
    """An optimizer by registered name (an Optimizer passes through)."""
    if isinstance(name, Optimizer):
        return name
    try:
        return _REGISTRY[name.lower()](**kwargs)
    except KeyError:
        raise ValueError(f"unknown optimizer {name!r}; registered: "
                         f"{sorted(_REGISTRY)}") from None


class Optimizer:
    """Base optimizer; subclasses implement ``create_state`` and
    ``update``."""

    def __init__(self, rescale_grad=1.0, param_idx2name=None, wd=0.0,
                 clip_gradient=None, learning_rate=0.01, lr_scheduler=None,
                 param_dict=None):
        self.rescale_grad = rescale_grad
        self.lr = learning_rate
        self.lr_scheduler = lr_scheduler
        if lr_scheduler is not None:
            self.lr_scheduler.base_lr = learning_rate
        self.wd = wd
        self.lr_mult = {}
        self.wd_mult = {}
        self.num_update = 0
        self._index_update_count = {}
        self.clip_gradient = clip_gradient
        self.idx2name = dict(param_idx2name or {})
        self.param_dict = param_dict or {}

    def __getstate__(self):
        # the Parameters (and their weights) stay out of saved states;
        # the Trainer sets param_dict again after loading
        state = dict(self.__dict__)
        state["param_dict"] = {}
        return state

    def create_state(self, index, weight):
        return None

    def update(self, index, weight, grad, state):
        raise NotImplementedError

    def update_multi(self, indices, weights, grads, states):
        """Update many parameters; the base loops over them."""
        for i, w, g, s in zip(indices, weights, grads, states):
            self.update(i, w, g, s)

    def set_learning_rate(self, lr):
        if self.lr_scheduler is not None:
            raise MXNetError("lr_scheduler is set; cannot set learning "
                             "rate directly")
        self.lr = lr

    @property
    def learning_rate(self):
        if self.lr_scheduler is not None:
            return self.lr_scheduler(self.num_update)
        return self.lr

    def set_lr_mult(self, args_lr_mult):
        self.lr_mult = dict(args_lr_mult)

    def set_wd_mult(self, args_wd_mult):
        self.wd_mult = dict(args_wd_mult)

    def _update_count(self, index):
        if not isinstance(index, (list, tuple)):
            index = [index]
        for idx in index:
            self._index_update_count[idx] = \
                self._index_update_count.get(idx, 0) + 1
            self.num_update = max(self._index_update_count[idx],
                                  self.num_update)

    def _mult(self, index, attr, table):
        name = self.idx2name.get(index, index)
        if name in self.param_dict:
            return getattr(self.param_dict[name], attr)
        if index in table:
            return table[index]
        return table.get(name, 1.0)

    def _get_lr(self, index):
        lr = self.lr_scheduler(self.num_update) if self.lr_scheduler \
            else self.lr
        return lr * self._mult(index, "lr_mult", self.lr_mult)

    def _get_wd(self, index):
        return self.wd * self._mult(index, "wd_mult", self.wd_mult)

    def _common_kwargs(self, index):
        kw = {"lr": self._get_lr(index), "wd": self._get_wd(index),
              "rescale_grad": self.rescale_grad}
        if self.clip_gradient is not None:
            kw["clip_gradient"] = self.clip_gradient
        return kw


@register
class SGD(Optimizer):
    """SGD with optional momentum (``sgd_update`` / ``sgd_mom_update``)."""

    def __init__(self, momentum=0.0, **kwargs):
        super().__init__(**kwargs)
        self.momentum = momentum

    def create_state(self, index, weight):
        if self.momentum == 0.0:
            return None
        return torch.zeros_like(weight)

    def update(self, index, weight, grad, state):
        self._update_count(index)
        kw = self._common_kwargs(index)
        if state is None:
            _ops.sgd_update(weight, grad, **kw)
        else:
            _ops.sgd_mom_update(weight, grad, state, momentum=self.momentum,
                                **kw)

    def update_multi(self, indices, weights, grads, states):
        """One multi-tensor op over the whole list
        (``multi_sgd_update`` / ``multi_sgd_mom_update``)."""
        self._update_count(list(indices))
        kw = {"lrs": [self._get_lr(i) for i in indices],
              "wds": [self._get_wd(i) for i in indices],
              "rescale_grad": self.rescale_grad}
        if self.clip_gradient is not None:
            kw["clip_gradient"] = self.clip_gradient
        if self.momentum == 0.0:
            _ops.multi_sgd_update(weights, grads, **kw)
        else:
            _ops.multi_sgd_mom_update(weights, grads, states,
                                      momentum=self.momentum, **kw)


@register
class Adam(Optimizer):
    """MXNet's Adam (module docstring): bias correction folded into lr,
    wd added to the gradient."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1, self.beta2, self.epsilon = beta1, beta2, epsilon

    def create_state(self, index, weight):
        return torch.zeros_like(weight), torch.zeros_like(weight)

    def _adam_kwargs(self, index):
        self._update_count(index)
        t = self._index_update_count[index]
        kw = self._common_kwargs(index)
        coef1 = 1.0 - self.beta1 ** t
        coef2 = 1.0 - self.beta2 ** t
        kw["lr"] = kw["lr"] * math.sqrt(coef2) / coef1
        kw.update(beta1=self.beta1, beta2=self.beta2, epsilon=self.epsilon)
        return kw

    def update(self, index, weight, grad, state):
        mean, var = state
        _ops.adam_update(weight, grad, mean, var, **self._adam_kwargs(index))


@register
class AdamW(Adam):
    """AdamW: wd added to the update, not the gradient."""

    def update(self, index, weight, grad, state):
        mean, var = state
        _ops.adamw_update(weight, grad, mean, var,
                          **self._adam_kwargs(index))


class Updater:
    """Applies an optimizer by parameter index, keeping its states."""

    def __init__(self, optimizer):
        self.optimizer = optimizer
        self.states = {}

    def _state(self, index, weight):
        if index not in self.states:
            self.states[index] = self.optimizer.create_state(index, weight)
        return self.states[index]

    def __call__(self, index, grad, weight):
        self.optimizer.update(index, weight, grad,
                              self._state(index, weight))

    def update_multi(self, indices, grads, weights):
        """All the given parameters in one call (the Trainer's path)."""
        states = [self._state(i, w) for i, w in zip(indices, weights)]
        self.optimizer.update_multi(indices, weights, grads, states)

    def set_states(self, states):
        """Load :meth:`get_states`'s bytes (the states come as CPU
        tensors). Raises ``MXNetError`` for the JAX package's states,
        which pickle its own classes: the port reads them only by
        importing that package, which it never does."""
        foreign = _jax_package_globals(states)
        if foreign:
            raise MXNetError(
                f"these optimizer states were written by the JAX package "
                f"(they pickle {sorted(foreign)[:3]}): its .states files "
                f"pickle its own classes and cannot be read by the port; "
                f"carry the weights in a .params file instead")
        self.states, second = pickle.loads(states)
        if isinstance(second, Optimizer):
            self.optimizer = second
        else:
            self.optimizer.num_update = second

    def get_states(self, dump_optimizer=False):
        """The states (as CPU tensors, so the bytes load on any
        device) and the optimizer or its update count, pickled."""
        states = {i: move_state(s, "cpu") for i, s in self.states.items()}
        return pickle.dumps(
            (states, self.optimizer) if dump_optimizer
            else (states, self.optimizer.num_update))


def move_state(state, device):
    """An optimizer state (a tensor, a tuple or list of them, or None)
    as plain tensors on ``device``."""
    if isinstance(state, torch.Tensor):
        return state.detach().as_subclass(torch.Tensor).to(device)
    if isinstance(state, (tuple, list)):
        return type(state)(move_state(s, device) for s in state)
    return state


def _jax_package_globals(payload):
    """The JAX package's module names among a pickle's globals (read
    from its opcodes, importing nothing)."""
    found = set()
    for _, arg, _ in pickletools.genops(payload):
        if isinstance(arg, str):
            mod = arg.split(" ")[0]
            if mod == "mxnet_tpu" or mod.startswith("mxnet_tpu."):
                found.add(mod)
    return found


def get_updater(optimizer):
    return Updater(optimizer)
