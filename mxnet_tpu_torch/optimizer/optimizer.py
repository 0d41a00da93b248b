"""Optimizers: the registry, ``Optimizer`` and its subclasses, and the
``Updater``.

Port of ``mxnet_tpu/optimizer/optimizer.py``: SGD, NAG, Adam, AdamW,
AdaGrad, AdaDelta, RMSProp (``centered``), Ftrl, Signum, LAMB, SGLD,
DCASGD, LBSGD and Test. Same surface and semantics: a name registry
(``create("adam", ...)``), per-parameter state made on first update,
index-keyed ``update`` with per-index update counts starting from
``begin_num_update`` (``num_update`` is their maximum, and what
``lr_scheduler`` reads), ``rescale_grad``, ``wd``, ``clip_gradient``,
per-parameter ``lr_mult``/``wd_mult`` (from the Trainer's Parameters,
else from ``set_lr_mult``/``set_wd_mult``). ``multi_precision`` keeps
a float32 master copy of each float16/bfloat16 weight
(``create_state_multi_precision``): the update runs on the master and
the weight takes its rounding. The updates are the in-place ops of
``ndarray.op_impl_optimizer``. A ``RowSparseNDArray`` gradient (a
row_sparse push through the kvstore) takes the lazy row update of
``ndarray.sparse`` (``sgd_update_rsp``, ``sgd_mom_update_rsp``,
``adam_update_rsp``, ``adagrad_update_rsp``): only its rows move.
Indices may be any hashable key (the Trainer's are integers, a
kvstore's may be strings such as ``"weight"``).

The math is MXNet's, not ``torch.optim``'s. MXNet's Adam folds the
bias correction into the learning rate (``lr * sqrt(1 - beta2**t) /
(1 - beta1**t)``), keeps epsilon outside the uncorrected square root,
and adds ``wd * weight`` to the gradient; AdamW adds it to the update
instead. SGLD draws its noise from the weight's device generator
(``mx.random.seed``), not the JAX package's key chain. LBSGD reads two
norms a parameter back to the host each step, as the JAX package does.
"""
from __future__ import annotations

import math
import pickle
import pickletools

import torch

from ..base import MXNetError
from ..ndarray import op_impl_optimizer as _ops
from ..ndarray import sparse as _sparse

__all__ = ["DCASGD", "LAMB", "LBSGD", "NAG", "SGD", "SGLD", "AdaDelta",
           "AdaGrad", "Adam", "AdamW", "Ftrl", "Optimizer", "RMSProp",
           "Signum", "Test", "Updater", "create", "get_updater",
           "register"]

_LOW_PRECISION = (torch.float16, torch.bfloat16)

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
                 sym=None, begin_num_update=0, multi_precision=False,
                 param_dict=None):
        self.rescale_grad = rescale_grad
        self.lr = learning_rate
        self.lr_scheduler = lr_scheduler
        if lr_scheduler is not None:
            self.lr_scheduler.base_lr = learning_rate
        self.wd = wd
        self.lr_mult = {}
        self.wd_mult = {}
        self.begin_num_update = begin_num_update
        self.num_update = begin_num_update
        self._index_update_count = {}
        self.clip_gradient = clip_gradient
        self.multi_precision = multi_precision
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

    def _mp(self, weight):
        return self.multi_precision and weight.dtype in _LOW_PRECISION

    def create_state_multi_precision(self, index, weight):
        """With ``multi_precision``, a float16/bfloat16 weight's state
        is ``(state of its float32 master, the master)``."""
        if self._mp(weight):
            master = weight.detach().as_subclass(torch.Tensor).float()
            return self.create_state(index, master), master
        return self.create_state(index, weight)

    def update(self, index, weight, grad, state):
        raise NotImplementedError

    def update_multi_precision(self, index, weight, grad, state):
        """:meth:`update`, on the float32 master of a low-precision
        weight under ``multi_precision`` (the weight takes its
        rounding)."""
        if self._mp(weight):
            inner, master = state
            self.update(index, master, grad.float(), inner)
            with torch.no_grad():
                weight.copy_(master)
        else:
            self.update(index, weight, grad, state)

    def update_multi(self, indices, weights, grads, states):
        """Update many parameters; the base loops over them."""
        for i, w, g, s in zip(indices, weights, grads, states):
            self.update_multi_precision(i, w, g, s)

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
            self._index_update_count[idx] = self._index_update_count.get(
                idx, self.begin_num_update) + 1
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
    """SGD with optional momentum (``sgd_update`` / ``sgd_mom_update``;
    a row_sparse gradient: ``sgd_update_rsp`` / ``sgd_mom_update_rsp``,
    ``lazy_update`` taken as the JAX optimizer takes it)."""

    def __init__(self, momentum=0.0, lazy_update=True, **kwargs):
        super().__init__(**kwargs)
        self.momentum = momentum
        self.lazy_update = lazy_update

    def create_state(self, index, weight):
        if self.momentum == 0.0:
            return None
        return torch.zeros_like(weight)

    def update(self, index, weight, grad, state):
        self._update_count(index)
        kw = self._common_kwargs(index)
        if isinstance(grad, _sparse.RowSparseNDArray):
            if state is None:
                _sparse.sgd_update_rsp(weight, grad, **kw)
            else:
                _sparse.sgd_mom_update_rsp(weight, grad, state,
                                           momentum=self.momentum,
                                           lazy_update=self.lazy_update,
                                           **kw)
            return
        if state is None:
            _ops.sgd_update(weight, grad, **kw)
        else:
            _ops.sgd_mom_update(weight, grad, state, momentum=self.momentum,
                                **kw)

    def update_multi(self, indices, weights, grads, states):
        """One multi-tensor op over the whole list
        (``multi_sgd_update`` / ``multi_sgd_mom_update``); sparse
        gradients take the per-index path."""
        if self.multi_precision or any(
                isinstance(g, _sparse.BaseSparseNDArray) for g in grads):
            return super().update_multi(indices, weights, grads, states)
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
                 epsilon=1e-8, lazy_update=True, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1, self.beta2, self.epsilon = beta1, beta2, epsilon
        self.lazy_update = lazy_update

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
        kw = self._adam_kwargs(index)
        if isinstance(grad, _sparse.RowSparseNDArray):
            _sparse.adam_update_rsp(weight, grad, mean, var,
                                    lazy_update=self.lazy_update, **kw)
            return
        _ops.adam_update(weight, grad, mean, var, **kw)


@register
class AdamW(Adam):
    """AdamW: wd added to the update, not the gradient."""

    def update(self, index, weight, grad, state):
        mean, var = state
        _ops.adamw_update(weight, grad, mean, var,
                          **self._adam_kwargs(index))


@register
class AdaGrad(Optimizer):
    """AdaGrad (``adagrad_update``; a row_sparse gradient:
    ``adagrad_update_rsp``): the squared gradients summed per element,
    ``eps`` inside the square root."""

    def __init__(self, eps=1e-7, **kwargs):
        super().__init__(**kwargs)
        self.float_stable_eps = eps

    def create_state(self, index, weight):
        return torch.zeros_like(weight)

    def update(self, index, weight, grad, state):
        self._update_count(index)
        kw = self._common_kwargs(index)
        kw["epsilon"] = self.float_stable_eps
        if isinstance(grad, _sparse.RowSparseNDArray):
            _sparse.adagrad_update_rsp(weight, grad, state, **kw)
            return
        _ops.adagrad_update(weight, grad, state, **kw)


@register
class NAG(SGD):
    """Nesterov momentum (``nag_mom_update``; no momentum:
    ``sgd_update``). Its math is not SGD's, so no multi-tensor op."""

    update_multi = Optimizer.update_multi

    def update(self, index, weight, grad, state):
        self._update_count(index)
        kw = self._common_kwargs(index)
        if state is None:
            _ops.sgd_update(weight, grad, **kw)
        else:
            _ops.nag_mom_update(weight, grad, state, momentum=self.momentum,
                                **kw)


@register
class AdaDelta(Optimizer):
    """AdaDelta (``adadelta_update``): no learning rate."""

    def __init__(self, rho=0.90, epsilon=1e-5, **kwargs):
        super().__init__(**kwargs)
        self.rho, self.epsilon = rho, epsilon

    def create_state(self, index, weight):
        return torch.zeros_like(weight), torch.zeros_like(weight)

    def update(self, index, weight, grad, state):
        self._update_count(index)
        kw = {"wd": self._get_wd(index), "rescale_grad": self.rescale_grad,
              "rho": self.rho, "epsilon": self.epsilon}
        if self.clip_gradient is not None:
            kw["clip_gradient"] = self.clip_gradient
        acc_g, acc_delta = state
        _ops.adadelta_update(weight, grad, acc_g, acc_delta, **kw)


@register
class RMSProp(Optimizer):
    """RMSProp (``rmsprop_update``), or with ``centered`` Graves's
    (``rmspropalex_update``)."""

    def __init__(self, learning_rate=0.001, gamma1=0.9, gamma2=0.9,
                 epsilon=1e-8, centered=False, clip_weights=None, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.gamma1, self.gamma2 = gamma1, gamma2
        self.centered = centered
        self.epsilon = epsilon
        self.clip_weights = clip_weights

    def create_state(self, index, weight):
        if self.centered:
            return tuple(torch.zeros_like(weight) for _ in range(3))
        return torch.zeros_like(weight)

    def update(self, index, weight, grad, state):
        self._update_count(index)
        kw = self._common_kwargs(index)
        kw.update(gamma1=self.gamma1, epsilon=self.epsilon)
        if self.clip_weights:
            kw["clip_weights"] = self.clip_weights
        if self.centered:
            n, g, delta = state
            _ops.rmspropalex_update(weight, grad, n, g, delta,
                                    gamma2=self.gamma2, **kw)
        else:
            _ops.rmsprop_update(weight, grad, state, **kw)


@register
class Ftrl(Optimizer):
    """FTRL-proximal (``ftrl_update``)."""

    def __init__(self, lamda1=0.01, learning_rate=0.1, beta=1.0, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.lamda1, self.beta = lamda1, beta

    def create_state(self, index, weight):
        return torch.zeros_like(weight), torch.zeros_like(weight)

    def update(self, index, weight, grad, state):
        self._update_count(index)
        kw = self._common_kwargs(index)
        z, n = state
        _ops.ftrl_update(weight, grad, z, n, lamda1=self.lamda1,
                         beta=self.beta, **kw)


@register
class Signum(Optimizer):
    """Signum (``signum_update``; no momentum: ``signsgd_update``)."""

    def __init__(self, learning_rate=0.01, momentum=0.9, wd_lh=0.0,
                 **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.momentum = momentum
        self.wd_lh = wd_lh

    def create_state(self, index, weight):
        if self.momentum == 0.0:
            return None
        return torch.zeros_like(weight)

    def update(self, index, weight, grad, state):
        self._update_count(index)
        kw = self._common_kwargs(index)
        if state is None:
            _ops.signsgd_update(weight, grad, **kw)
        else:
            _ops.signum_update(weight, grad, state, momentum=self.momentum,
                               wd_lh=self.wd_lh, **kw)


@register
class LAMB(Optimizer):
    """LAMB: ``lamb_update_phase1``, the weight's and the direction's
    norms (device tensors), then ``lamb_update_phase2``."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-6, lower_bound=None, upper_bound=None,
                 bias_correction=True, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1, self.beta2, self.epsilon = beta1, beta2, epsilon
        self.lower_bound, self.upper_bound = lower_bound, upper_bound
        self.bias_correction = bias_correction

    def create_state(self, index, weight):
        return torch.zeros_like(weight), torch.zeros_like(weight)

    def update(self, index, weight, grad, state):
        self._update_count(index)
        t = self._index_update_count[index]
        mean, var = state
        kw = {"beta1": self.beta1, "beta2": self.beta2,
              "epsilon": self.epsilon, "t": t,
              "bias_correction": self.bias_correction,
              "wd": self._get_wd(index), "rescale_grad": self.rescale_grad}
        if self.clip_gradient is not None:
            kw["clip_gradient"] = self.clip_gradient
        g = _ops.lamb_update_phase1(weight, grad, mean, var, **kw)
        with torch.no_grad():
            r1 = torch.linalg.vector_norm(weight)
            r2 = torch.linalg.vector_norm(g)
        kw2 = {"lr": self._get_lr(index)}
        if self.lower_bound:
            kw2["lower_bound"] = self.lower_bound
        if self.upper_bound:
            kw2["upper_bound"] = self.upper_bound
        _ops.lamb_update_phase2(weight, g, r1, r2, **kw2)


@register
class SGLD(Optimizer):
    """Stochastic Gradient Langevin Dynamics: ``weight -= lr / 2 * (g +
    wd * weight)`` plus normal noise of variance ``lr``, drawn from the
    weight's device generator."""

    def update(self, index, weight, grad, state):
        self._update_count(index)
        lr, wd = self._get_lr(index), self._get_wd(index)
        with torch.no_grad():
            g = grad * self.rescale_grad
            if self.clip_gradient is not None:
                g = g.clamp(-self.clip_gradient, self.clip_gradient)
            noise = torch.randn(weight.shape, dtype=weight.dtype,
                                device=weight.device) * math.sqrt(lr)
            weight.copy_(weight - lr / 2 * (g + wd * weight) + noise)


@register
class DCASGD(Optimizer):
    """Delay-compensated asynchronous SGD: the gradient plus ``lamda *
    g * g * (weight - previous weight)``."""

    def __init__(self, momentum=0.0, lamda=0.04, **kwargs):
        super().__init__(**kwargs)
        self.momentum = momentum
        self.lamda = lamda

    def create_state(self, index, weight):
        prev = weight.detach().as_subclass(torch.Tensor).clone()
        if self.momentum == 0.0:
            return None, prev
        return torch.zeros_like(prev), prev

    def update(self, index, weight, grad, state):
        self._update_count(index)
        lr, wd = self._get_lr(index), self._get_wd(index)
        mom, previous_weight = state
        with torch.no_grad():
            g = grad * self.rescale_grad
            if self.clip_gradient is not None:
                g = g.clamp(-self.clip_gradient, self.clip_gradient)
            comp = g + self.lamda * g * g * (weight - previous_weight)
            if mom is None:
                new = weight - lr * (comp + wd * weight)
            else:
                mom.copy_(self.momentum * mom - lr * (comp + wd * weight))
                new = weight + mom
            previous_weight.copy_(weight)
            weight.copy_(new)


@register
class LBSGD(SGD):
    """Large-batch SGD with a LARS trust ratio a layer: ``0.001 *
    |w| / (|g| + wd * |w|)`` scales the learning rate. The two norms
    are read back to the host a parameter a step, as in the JAX
    package."""

    update_multi = Optimizer.update_multi

    def __init__(self, momentum=0.0, warmup_strategy="linear",
                 warmup_epochs=5, batch_scale=1, updates_per_epoch=32,
                 begin_epoch=0, num_epochs=60, **kwargs):
        super().__init__(momentum=momentum, **kwargs)
        self.warmup_strategy = warmup_strategy

    def update(self, index, weight, grad, state):
        with torch.no_grad():
            w_norm = float(torch.linalg.vector_norm(weight))
            g_norm = float(torch.linalg.vector_norm(grad
                                                    * self.rescale_grad))
        trust = 1.0
        if w_norm > 0 and g_norm > 0:
            trust = 0.001 * w_norm / (g_norm + self._get_wd(index) * w_norm)
        saved_lr = self.lr
        try:
            if self.lr_scheduler is None:
                self.lr = self.lr * trust
            super().update(index, weight, grad, state)
        finally:
            self.lr = saved_lr


@register
class Test(Optimizer):
    """The reference's unit-test optimizer: ``weight += grad *
    rescale_grad``."""

    def create_state(self, index, weight):
        return torch.zeros_like(weight)

    def update(self, index, weight, grad, state):
        with torch.no_grad():
            weight.add_(grad * self.rescale_grad)


class Updater:
    """Applies an optimizer by parameter index, keeping its states."""

    def __init__(self, optimizer):
        self.optimizer = optimizer
        self.states = {}

    def _state(self, index, weight):
        if index not in self.states:
            self.states[index] = \
                self.optimizer.create_state_multi_precision(index, weight)
        return self.states[index]

    def __call__(self, index, grad, weight):
        self.optimizer.update_multi_precision(index, weight, grad,
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
