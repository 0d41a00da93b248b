"""Executor: a bound symbolic computation.

Port of ``mxnet_tpu/executor.py`` (MXNet's GraphExecutor and
``python/mxnet/executor.py``). The JAX executor traces the whole Symbol
DAG into one jitted XLA program per ``(training, names, shapes,
dtypes)`` key; here the same key is an entry of the CachedOp machinery
that hybridized blocks use (``gluon.block``'s ``_Entry``):

- **On the card** each key is a CUDA graph (``graphs``) of the walk
  over plain tensors (:meth:`~.symbol.Symbol._eval_raw`), captured at
  its first call after an eager warm-up and replayed after that. Under
  ``forward(is_train=True)`` the key is two graphs, the forward and its
  backward (``torch.autograd.grad`` over the arrays that take
  gradients), joined by one ``torch.autograd.Function``. An array that
  takes a gradient is differentiated through a leaf alias of its
  memory (made once an array and kept on it), so the bound arrays
  themselves never require gradients and take in-place writes
  anywhere. The graphs read the bound arrays where they are:
  ``forward(**kwargs)``, ``copy_params_from``, ``Module.update`` and
  ``Module.set_params`` write into them in place. An entry also holds the arrays' addresses,
  so an array replaced in ``arg_dict`` makes that key capture again,
  never a graph that reads the old one. A capture that fails raises
  ``MXNetError`` (``graphs``' rule); nothing falls back to the eager
  walk. Outputs and gradients are copies out of the graphs' static
  buffers, so each forward's outputs stay valid after the next.
- **On CPU tensors** the same entry runs the walk eagerly where the
  card would replay (keys, parameter aliases and the ``Function``
  included).
- ``MXNET_TPU_SYMBOLIC_JIT=0`` runs the eager walk through ``invoke``
  (:meth:`~.symbol.Symbol._eval`) on any device, the JAX package's
  debug ladder.

:meth:`Executor.backward` takes the gradients of the outputs (with
``out_grads``, or ones: a loss head such as ``SoftmaxOutput`` takes its
own gradient whatever its head gradient) with respect to every array
whose ``grad_req`` is not ``"null"``, and writes them into
``grad_dict``'s arrays (``"write"``) or adds them (``"add"``).
:meth:`Executor.reshape` shares the graph cache and its memory pool.
The JAX key's AMP generation and its persistent compile cache have no
counterpart here yet.
"""
from __future__ import annotations

import contextlib

import torch

from . import autograd, envvars
from .base import MXNetError
from .context import current_context, resolve_device
from .ndarray.ndarray import NDArray

__all__ = ["Executor"]


class _GraphCache:
    """Entries by key (the symbol's identity first: each entry's owner
    holds its symbol), and the graph memory pool they capture in; shared
    by :meth:`Executor.reshape` and by a ``BucketingModule``'s
    buckets."""

    def __init__(self):
        self.entries = {}
        self._pool = None

    def pool(self):
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        return self._pool


class _BoundWalk:
    """The owner of an executor's entry (``gluon.block._Entry``): the
    walk of ``symbol`` over ``names`` bound to ``arrays``, in train or
    predict mode."""

    def __init__(self, symbol, names, arrays, training, cache, device):
        self.symbol = symbol
        self.names = names
        self.arrays = arrays
        self.training = training
        self.cache = cache
        self.device = device
        self.aliases = {}

    def _body(self, spec, tensors):
        bindings = {n: self.aliases.get(id(a), a).as_subclass(torch.Tensor)
                    for n, a in zip(self.names, self.arrays)}
        prev = autograd.set_training(self.training)
        try:
            return self.symbol._eval_raw(bindings, self.device)
        finally:
            autograd.set_training(prev)

    def _pool(self):
        return self.cache.pool()

    @contextlib.contextmanager
    def _swapped(self, aliases):
        self.aliases = aliases
        try:
            yield self
        finally:
            self.aliases = {}

    def _graph_state(self, params):
        return []           # the walk updates nothing in place


def _leaf(arr):
    """The leaf alias of ``arr``'s memory that gradients are taken for
    (module docstring); one per array, so executors sharing an array
    share its graphs."""
    leaf = arr.__dict__.get("_mx_leaf")
    if leaf is None:
        leaf = arr.detach().requires_grad_(True)
        arr.__dict__["_mx_leaf"] = leaf
    return leaf


class Executor:
    def __init__(self, symbol, ctx, args, args_grad=None, grad_req="write",
                 aux_states=None, _graph_cache=None):
        from . import ndarray as nd

        self._symbol = symbol
        self._ctx = ctx or current_context()
        arg_names = symbol.list_arguments()
        if isinstance(args, (list, tuple)):
            args = dict(zip(arg_names, args))
        self.arg_dict = dict(args)
        self.arg_arrays = [self.arg_dict.get(n) for n in arg_names]
        if isinstance(args_grad, (list, tuple)):
            args_grad = dict(zip(arg_names, args_grad))
        self.grad_req = grad_req if isinstance(grad_req, dict) else \
            {n: grad_req for n in arg_names}
        self.grad_dict = dict(args_grad) if args_grad else {}
        for n in arg_names:
            req = self.grad_req.get(n, "null")
            if req != "null" and n not in self.grad_dict and \
                    n in self.arg_dict:
                self.grad_dict[n] = nd.zeros_like(self.arg_dict[n])
        self.grad_arrays = [self.grad_dict.get(n) for n in arg_names]
        self.aux_dict = dict(aux_states or {})
        self.aux_arrays = list(self.aux_dict.values())
        self.outputs = []
        self._monitor_callback = None
        self._recording = False
        self._jit = envvars.get("MXNET_TPU_SYMBOLIC_JIT")
        # key -> entry (graphs), shared with reshape()-derived executors
        self._graph_cache = _graph_cache if _graph_cache is not None \
            else _GraphCache()

    @property
    def symbol(self):
        return self._symbol

    def set_monitor_callback(self, callback, monitor_all=False):
        self._monitor_callback = callback

    def forward(self, is_train=False, **kwargs):
        with torch.no_grad():
            for k, v in kwargs.items():
                if k in self.arg_dict:
                    dst = self.arg_dict[k]
                    if v is not dst:
                        dst.copy_(torch.as_tensor(v))
                else:
                    self.arg_dict[k] = v
        scope = autograd.record(train_mode=True) if is_train \
            else autograd.pause(train_mode=False)
        bindings = {**self.arg_dict, **self.aux_dict}
        for n in self._grad_names():
            bindings[n] = _leaf(bindings[n])
        with scope:
            if self._jit:
                outs = self._forward_graph(bindings, bool(is_train))
            else:
                outs = self._symbol._eval(bindings, training=bool(is_train))
        self.outputs = [o if isinstance(o, NDArray) else
                        o.as_subclass(NDArray) for o in outs]
        self._recording = bool(is_train)
        if self._monitor_callback is not None:
            for name, out in zip(self._symbol.list_outputs(), self.outputs):
                self._monitor_callback(name, out)
        return self.outputs

    def _forward_graph(self, bindings, is_train):
        """One call of this binding key's entry (module docstring)."""
        from .gluon.block import _Entry, _psig

        names = list(bindings)
        arrays = [bindings[n] for n in names]
        # laid out as a block's key: (spec, training, recording,
        # inference mode)
        key = ((id(self._symbol),
                tuple((n, tuple(a.shape), a.dtype, a.device, a.requires_grad)
                      for n, a in zip(names, arrays))),
               is_train, torch.is_grad_enabled(),
               torch.is_inference_mode_enabled())
        psig = _psig(arrays)
        cache = self._graph_cache.entries
        entry = cache.get(key)
        if entry is None or entry.psig != psig:
            device = resolve_device(self._ctx)
            owner = _BoundWalk(self._symbol, names, arrays, is_train,
                               self._graph_cache, device)
            what = (f"executor of symbol '{self._symbol.name or 'group'}' "
                    f"at key ({len(names)} arrays; training {is_train})")
            entry = _Entry(owner, key, None, [], arrays, psig, what,
                           device=device)
            cache[key] = entry
        return entry([])

    def backward(self, out_grads=None, is_train=True):
        if not self._recording:
            raise MXNetError("backward called without forward(is_train=True)")
        if out_grads is None:
            out_grads = [None] * len(self.outputs)
        elif isinstance(out_grads, torch.Tensor):
            out_grads = [out_grads]
        heads, head_grads = [], []
        for o, g in zip(self.outputs, out_grads):
            if o.requires_grad:
                heads.append(o)
                head_grads.append(torch.ones_like(o) if g is None else g)
        targets = [(n, _leaf(self.arg_dict[n])) for n in self._grad_names()]
        self._recording = False
        if not heads or not targets:
            return
        with autograd.hooks_off(), autograd.train_mode():
            grads = torch.autograd.grad(heads, [a for _, a in targets],
                                        head_grads, allow_unused=True)
        with torch.no_grad():
            for (n, _), g in zip(targets, grads):
                if g is None:
                    continue
                buf = self.grad_dict[n]
                if self.grad_req[n] == "add":
                    buf.add_(g)
                else:
                    buf.copy_(g)

    def _grad_names(self):
        return [n for n in self._symbol.list_arguments()
                if self.grad_req.get(n, "null") != "null"
                and n in self.arg_dict]

    def reshape(self, partial_shaping=False, allow_up_sizing=False, **kwargs):
        from . import ndarray as nd
        new_args = {}
        for n, arr in self.arg_dict.items():
            if n in kwargs:
                new_args[n] = nd.zeros(kwargs[n], ctx=self._ctx,
                                       dtype=arr.dtype)
            else:
                new_args[n] = arr
        # shares the graph cache: one entry per shape, and unchanged
        # arrays keep their gradient buffers
        return Executor(self._symbol, self._ctx, new_args,
                        {n: (self.grad_dict[n]
                             if n in self.grad_dict and n not in kwargs
                             else nd.zeros_like(a))
                         for n, a in new_args.items()
                         if self.grad_req.get(n, "null") != "null"},
                        self.grad_req, self.aux_dict,
                        _graph_cache=self._graph_cache)

    def copy_params_from(self, arg_params, aux_params=None,
                         allow_extra_params=False):
        with torch.no_grad():
            for name, arr in arg_params.items():
                if name in self.arg_dict:
                    self.arg_dict[name].copy_(arr)
                elif not allow_extra_params:
                    raise MXNetError(f"Found name \"{name}\" that is not in "
                                     f"the arguments")
            for name, arr in (aux_params or {}).items():
                if name in self.aux_dict:
                    self.aux_dict[name].copy_(arr)
                elif not allow_extra_params:
                    raise MXNetError(f"Found name \"{name}\" that is not in "
                                     f"the auxiliary states")

    @property
    def output_dict(self):
        return dict(zip(self._symbol.list_outputs(), self.outputs))
